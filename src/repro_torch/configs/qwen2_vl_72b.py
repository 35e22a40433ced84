"""Qwen2-VL-72B backbone — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, head_dim=128.

The vision frontend is a stub: the model takes precomputed patch/text
embeddings (B, S, d) (``batch["embeds"]``); M-RoPE positions are the
(temporal, height, width) triple — identical streams for text tokens."""

import dataclasses

from repro_torch.lm.config import ArchConfig

ARCH = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab=152_064,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    embedding_inputs=True,
    grad_accum=2,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab=512, mrope_sections=(4, 6, 6), dtype="float32",
    attn_chunk=16, grad_accum=1,
)
