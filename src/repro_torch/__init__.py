"""PyTorch/CUDA port of the Homa simulator (``repro``'s JAX package).

Runs on a CUDA card unless the caller passes ``device="cpu"``; imports
nothing of JAX or of the ``repro`` package.
"""
from repro_torch.core import *  # noqa: F401,F403
from repro_torch.core import __all__  # noqa: F401
