"""DeepSeek-Coder-33B — llama-arch dense [arXiv:2401.14196; hf].
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256, head_dim=128."""

import dataclasses

from repro_torch.lm.config import ArchConfig

ARCH = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19_200,
    vocab=32_256,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=100_000.0,
    grad_accum=2,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab=512, dtype="float32", attn_chunk=16, grad_accum=1,
)
