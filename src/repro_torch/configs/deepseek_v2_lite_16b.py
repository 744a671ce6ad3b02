"""deepseek-v2-lite-16b [moe] — 27L d_model=2048, MLA (kv_lora=512, rope
head 64, 16 heads x 128), MoE 64 routed top-6 + 2 shared, moe_d_ff=1408,
first layer dense (d_ff=10944), vocab=102400. [arXiv:2405.04434]

Full-size DeepSeek-V2 has 160 routed experts; the lite config here is 64
routed + 2 shared, top-6, per the paper.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400, rope_theta=10_000.0,
    use_mla=True, kv_lora_rank=512, rope_head_dim=64, v_head_dim=128,
    num_experts=64, num_shared_experts=2, experts_per_token=6, moe_d_ff=1408,
    first_dense_layers=1,
))
