"""RWKV-6 'Finch' 3B — attention-free, data-dependent decay
[arXiv:2404.05892; hf].  32L d_model=2560 d_ff=8960 vocab=65536,
head size 64 (40 heads).  O(1) decode state -> runs the long_500k cell."""

import dataclasses

from repro_torch.lm.config import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65_536,
    act="relu_sq",
    norm="layernorm",
    block_pattern=("rwkv6",),
    pos_embed="none",
    rwkv_head_dim=64,
    rwkv_remat_chunk=True,   # §Perf cell A: recompute intra-chunk tensors
                             # in backward (4.2x memory-term win, A1)
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab=512, rwkv_head_dim=32, dtype="float32", grad_accum=1,
)
