"""Gemma-7B — GeGLU, head_dim=256 [arXiv:2403.08295; hf].
28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000."""

import dataclasses

from repro_torch.lm.config import ArchConfig

ARCH = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab=256_000,
    act="geglu",
    norm="gemma_rmsnorm",
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, dtype="float32", attn_chunk=16, grad_accum=1,
)
