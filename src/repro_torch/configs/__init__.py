"""Config registry: one module per architecture the port runs.

``mamba2-130m`` (ssm) and ``llama3.2-3b`` (dense GQA attention) so far;
the JAX package's other architectures need MLA, MoE, cross-attention or
encoder code the port does not have yet (ROADMAP A11).
"""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, get_config, register,
)

_ARCH_MODULES = [
    "mamba2_130m",
    "llama3_2_3b",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


ARCH_NAMES = ["mamba2-130m", "llama3.2-3b"]
