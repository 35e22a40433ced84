"""Kimi K2 — trillion-parameter MoE (paper-table config) [arXiv:2501.kimi2;
unverified].  61L d_model=7168 64H (GQA kv=8) vocab=163840; MoE: 384 routed
experts top-8 + 1 shared, d_ff_expert=2048 (fine-grained DeepSeek-style)."""

import dataclasses

from repro_torch.lm.config import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163_840,
    act="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048, num_shared=1),
    rope_theta=50_000.0,
    grad_accum=8,          # 1T-param cells bound activation memory this way
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=512,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96, num_shared=1,
                  capacity_factor=2.0),
    dtype="float32", attn_chunk=16, grad_accum=1,
)
