"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768 d_ff=0 vocab=50280 ssm_state=128. [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm_state_dim=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True, norm_type="rmsnorm",
))
