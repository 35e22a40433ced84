"""Grok-1 — 314B MoE, 8 experts top-2 [hf:xai-org/grok-1; unverified].
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.

On one device the MoE runs the dense ``ref`` dispatch (lm/moe.py); the
reference's mesh dispatch ('tp': 8 experts under a 16-way model axis)
waits for multi-GPU.
"""

import dataclasses

from repro_torch.lm.config import ArchConfig, MoEConfig

ARCH = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab=131_072,
    act="geglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32_768),
    rope_theta=10_000.0,
    grad_accum=4,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128,
                  capacity_factor=2.0),
    dtype="float32", attn_chunk=16, grad_accum=1,
)
