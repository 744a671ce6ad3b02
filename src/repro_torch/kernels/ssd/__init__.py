"""Mamba2 SSD (state-space duality) chunk scan: the hand-written CUDA
kernels (``csrc/ssd.cu``: a tensor-core route and a CUDA-core one,
wrapper ``kernel.ssd_scan``), their plain PyTorch version
(``ref.ssd_ref``) and the padding entry point the model calls
(``ops.ssd``)."""
