"""Config registry: one module per architecture the port runs.

Every architecture of the JAX package's zoo, registered in its order:
ssm (``mamba2-130m``), the encoder-decoder (``whisper-small``), dense GQA
attention (``stablelm-12b``, ``llama3.2-3b``, ``llama3-405b``,
``qwen2-7b``), MoE (``mixtral-8x7b``), MLA + MoE
(``deepseek-v2-lite-16b``), the SSM/attention/MoE hybrid
(``jamba-1.5-large-398b``) and cross-attention to image embeddings
(``llama-3.2-vision-90b``).
"""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    SKIPPED_CELLS, ModelConfig, all_configs, cell_is_skipped, get_config,
    register,
)

_ARCH_MODULES = [
    "mamba2_130m",
    "whisper_small",
    "stablelm_12b",
    "llama3_2_3b",
    "llama3_405b",
    "qwen2_7b",
    "mixtral_8x7b",
    "deepseek_v2_lite_16b",
    "jamba_1_5_large_398b",
    "llama_3_2_vision_90b",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


ARCH_NAMES = [
    "mamba2-130m", "whisper-small", "stablelm-12b", "llama3.2-3b",
    "llama3-405b", "qwen2-7b", "mixtral-8x7b", "deepseek-v2-lite-16b",
    "jamba-1.5-large-398b", "llama-3.2-vision-90b",
]
