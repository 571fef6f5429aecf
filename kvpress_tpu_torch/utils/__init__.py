from .checkpoint import load_params, save_params
from .profiling import enable_compile_cache, memory_stats, profile_trace

__all__ = [
    "load_params", "save_params", "enable_compile_cache", "memory_stats",
    "profile_trace",
]
