from .llama import Runner, init_params, quantize_params_int8
from .convert import convert_state_dict, load_pretrained, params_from_jax

__all__ = ["Runner", "init_params", "quantize_params_int8", "convert_state_dict",
           "load_pretrained", "params_from_jax"]
