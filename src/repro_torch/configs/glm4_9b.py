"""GLM4-9B — RoPE, GQA [hf:THUDM/glm-4-9b].
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552, head_dim=128."""

import dataclasses

from repro_torch.lm.config import ArchConfig

ARCH = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab=151_552,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, dtype="float32", attn_chunk=16, grad_accum=1,
)
