"""Reduced (smoke-test) variants: same family and topology, tiny widths,
exactly as the JAX package's ``configs/reduced.py`` sizes them, so that a
test can run both packages on one configuration."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, get_config


def reduced_config(name: str) -> ModelConfig:
    cfg = get_config(name)
    period = cfg.block_period
    # keep >= 2 super-blocks so the stacked-block loop is exercised
    n_layers = max(2 * period, cfg.first_dense_layers + period)
    if cfg.first_dense_layers:
        n_layers = cfg.first_dense_layers + 2 * period
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=2 if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=24 if cfg.is_encoder_decoder else cfg.encoder_seq,
        num_image_tokens=16 if cfg.num_image_tokens else 0,
    )
    if cfg.use_mla:
        kw.update(kv_lora_rank=32, rope_head_dim=8, head_dim=16, v_head_dim=16,
                  num_kv_heads=4)
    if cfg.num_experts:
        # capacity_factor = E/K makes routing dropless, so prefill+decode is
        # bitwise-consistent with the full forward regardless of token count.
        kw.update(num_experts=4, experts_per_token=2, moe_d_ff=64,
                  capacity_factor=2.0)
    if cfg.ssm_state_dim:
        kw.update(ssm_state_dim=16, ssm_head_dim=8, ssm_chunk=8)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    return dataclasses.replace(cfg, **kw)
