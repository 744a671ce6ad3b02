"""Mamba2 SSD (state-space duality) chunk scan: the hand-written CUDA
kernel (``csrc/ssd.cu``, wrapper ``kernel.ssd_scan``), its plain PyTorch
version (``ref.ssd_ref``) and the padding entry point the model calls
(``ops.ssd``)."""
