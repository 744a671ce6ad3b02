"""Flash attention: the hand-written CUDA kernel (``csrc/attention.cu``,
wrapper ``kernel.flash_attention``), its plain PyTorch version
(``ref.attention_ref``) and the padding entry point the model calls
(``ops.attention``)."""
