"""Config registry: one module per architecture the port runs.

Only ``mamba2-130m`` so far; the JAX package's other architectures need
attention, MoE or encoder code the port does not have yet (ROADMAP
A11/B5).
"""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, get_config, register,
)

_ARCH_MODULES = [
    "mamba2_130m",
]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


ARCH_NAMES = ["mamba2-130m"]
