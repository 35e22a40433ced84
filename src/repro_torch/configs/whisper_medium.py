"""Whisper-medium — encoder-decoder audio backbone [arXiv:2212.04356;
unverified].  24+24L d_model=1024 16H d_ff=4096 vocab=51865; learned
positional embeddings, LayerNorm, GELU MLP.

The conv frontend is a stub: the encoder takes 1500 precomputed frame
embeddings (B, 1500, d) (``batch["enc_embeds"]``).  Decoder seq lengths
beyond Whisper's native 448 are config-driven extrapolation."""

import dataclasses

from repro_torch.lm.config import ArchConfig

ARCH = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51_865,
    act="gelu_mlp",
    norm="layernorm",
    pos_embed="learned",
    learned_pos_max=32_768,     # Whisper caps at 448; extrapolated for the
                                # 32k shape cells
    encoder_layers=24,
    encoder_ctx=1500,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    ARCH, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, encoder_layers=2, encoder_ctx=16, dtype="float32",
    attn_chunk=16, grad_accum=1,
)
