"""RecurrentGemma-2B — Griffin hybrid: RG-LRU + local attention, 1 attn : 2
recurrent [arXiv:2402.19427; hf].  26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000, head_dim=256, window 2048, GeGLU, gemma norms."""

import dataclasses

from repro_torch.lm.config import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    act="geglu",
    norm="gemma_rmsnorm",
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
    d_ff=128, vocab=512, window=8, lru_width=64, dtype="float32",
    attn_chunk=16, grad_accum=1,
)
