"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; every 5th layer cross-attends to image patch embeddings.
[hf:meta-llama/Llama-3.2-90B-Vision]

The vision tower is a stub, as in the JAX package: the caller supplies
6400 precomputed patch embeddings per sample (d_model wide,
``img_embeds``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, rope_theta=500_000.0,
    cross_attn_period=5, cross_attn_offset=4, num_image_tokens=6400,
    block_period=5,
))
