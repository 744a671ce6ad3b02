"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2, Mamba:attn 7:1 interleave.
[arXiv:2403.19887]

Adaptation note (DESIGN.md): Jamba-1.5 uses Mamba-1 layers; we implement its
SSM layers with the Mamba2/SSD block (the TPU-native chunked formulation this
framework provides); state=128, head_dim=64. MoE every other layer.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536, rope_theta=1_000_000.0,
    num_experts=16, experts_per_token=2, moe_d_ff=24576,
    moe_layer_period=2, moe_layer_offset=1,
    attn_layer_period=8, attn_layer_offset=4,
    ssm_state_dim=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    block_period=8,
))
