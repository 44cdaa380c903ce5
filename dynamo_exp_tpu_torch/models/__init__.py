from .config import (
    GEMMA2_9B,
    GEMMA_2B,
    LLAMA_1B,
    LLAMA_3B,
    LLAMA_8B,
    MISTRAL_7B,
    MIXTRAL_8X7B,
    PRESETS,
    QWEN2_7B,
    QWEN3_8B,
    TINY,
    TINY_MOE,
    TINY_QWEN2,
    TINY_QWEN3,
    ModelConfig,
)
from .convert import params_from_jax
from .gguf import GGUFFile, config_from_gguf, load_params_from_gguf
from .hub import resolve_model_path
from .llama import Llama, forward, forward_ragged, init_kv_cache, init_params

__all__ = [
    "ModelConfig",
    "TINY",
    "TINY_QWEN2",
    "TINY_QWEN3",
    "TINY_MOE",
    "LLAMA_1B",
    "LLAMA_3B",
    "LLAMA_8B",
    "QWEN2_7B",
    "QWEN3_8B",
    "GEMMA_2B",
    "GEMMA2_9B",
    "MISTRAL_7B",
    "MIXTRAL_8X7B",
    "PRESETS",
    "Llama",
    "forward",
    "forward_ragged",
    "init_params",
    "init_kv_cache",
    "params_from_jax",
    "GGUFFile",
    "config_from_gguf",
    "load_params_from_gguf",
    "resolve_model_path",
]
