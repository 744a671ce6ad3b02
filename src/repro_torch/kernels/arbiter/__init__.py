"""Per-slot arbitration: the ``priority_arbiter`` and ``srpt_topk`` CUDA
kernels (``csrc/arbiter.cu``), their plain PyTorch versions (``ref``) and
the backend dispatch the simulator calls."""
