"""whisper-small [audio] — enc-dec transformer backbone; conv frontend is a
stub (the caller supplies precomputed frame embeddings, ``enc_embeds``).

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865. [arXiv:2212.04356]
Adaptation note, as in the JAX package: rotary positions instead of
Whisper's absolute embeddings (framework-uniform position handling).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865,
    is_encoder_decoder=True, encoder_layers=12, encoder_seq=1500,
    norm_type="layernorm", act="gelu", rope_theta=10_000.0,
))
