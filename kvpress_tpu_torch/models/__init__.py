from .llama import Runner, init_params, init_params_int8, quantize_params_int8
from .convert import (convert_state_dict, from_torch_model, from_torch_multimodal,
                      load_pretrained, multimodal_embeds, params_from_jax)
from .siglip import VisionConfig, VisionTower, encode_images, init_vision_params

__all__ = ["Runner", "init_params", "init_params_int8", "quantize_params_int8",
           "convert_state_dict",
           "from_torch_model", "from_torch_multimodal", "load_pretrained",
           "multimodal_embeds", "params_from_jax", "VisionConfig", "VisionTower",
           "encode_images", "init_vision_params"]
