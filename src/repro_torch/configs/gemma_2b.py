"""Gemma-2B — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf].
18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000."""

import dataclasses

from repro_torch.lm.config import ArchConfig

ARCH = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab=256_000,
    act="geglu",
    norm="gemma_rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
    d_ff=128, vocab=512, dtype="float32", attn_chunk=16, grad_accum=1,
)
