"""Full-attention building blocks (port of ``repro/lm/blocks.py``, the
full-attention subset: norms, RoPE, causal query-chunked attention,
decode attention over the KV cache, gated dense FFN).

Every function takes (params-dict, inputs) tensors, as the reference
does.  Layouts are the reference's: activations (B, S, d), q/k/v
(B, S, H, hd), the KV cache ``{k, v}`` (B, S_max, Hkv, hd) plus radix
scales, positions (B, S).  Prefill attention is plain tensor code (the
reference's is plain jnp, not a Pallas kernel); decode attention over a
radix cache with ``packed_attn`` runs the decode-attention kernel.
Sliding windows (except in ``decode_mask``), M-RoPE, recurrent blocks,
cross-attention and the ungated FFNs are not ported yet.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.lm import radix as radix_lib
from repro_torch.lm.config import ArchConfig

__all__ = ["norm", "rope_apply", "attention", "decode_mask",
           "decode_attention", "ffn"]


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------


def norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind in ("rmsnorm", "gemma_rmsnorm"):
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + 1e-6)
        w = p["w"].to(torch.float32)
        scale = (1.0 + w) if kind == "gemma_rmsnorm" else w
        return (xf * scale).to(x.dtype)
    if kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        xf = (xf - mu) * torch.rsqrt(var + 1e-5)
        return (xf * p["w"] + p["b"]).to(x.dtype)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary embeddings (plain RoPE).
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, hd: int, theta: float
                 ) -> torch.Tensor:
    """(..., S) positions -> (..., S, hd//2) angles."""
    half = torch.arange(0, hd // 2, dtype=torch.float32,
                        device=positions.device)
    expo = -half / torch.tensor(float(hd // 2), device=positions.device)
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), expo)
    return positions.to(torch.float32)[..., None] * freq


def rope_apply(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate (B, S, H, hd) by positions (B, S)."""
    hd = x.shape[-1]
    ang = _rope_angles(positions, hd, theta)              # (B, S, hd/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)        # (B, S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention (prefill): query-chunked, GQA, causal.
# ---------------------------------------------------------------------------


def _attn_proj(x, w, cfg: ArchConfig):
    """x (B,S,d) @ w -> (B,S,H,hd).  ``w`` is a (d,H,hd) tensor, or under
    ``cfg.radix_attn`` a quantize_weight dict over the (d, H*hd) view."""
    if isinstance(w, dict):
        y = radix_lib.maybe_radix_matmul(x, w, cfg=cfg)
        return y.reshape(y.shape[:-1] + (-1, cfg.hd))
    return torch.einsum("bsd,dhk->bshk", x, w)


def _out_proj(o, w, cfg: ArchConfig):
    """(B,S,H,hd) @ wo -> (B,S,d); dict = flattened (H*hd, d) radix view."""
    if isinstance(w, dict):
        return radix_lib.maybe_radix_matmul(
            o.reshape(o.shape[:-2] + (-1,)), w, cfg=cfg)
    return torch.einsum("bshk,hkd->bsd", o, w)


def _qkv(x, p, cfg: ArchConfig):
    q = _attn_proj(x, p["wq"], cfg)                        # (B,S,H,hd)
    k = _attn_proj(x, p["wk"], cfg)                        # (B,S,Hkv,hd)
    v = _attn_proj(x, p["wv"], cfg)
    return q, k, v


def _gqa_scores(q, k):
    """(B,Sq,H,hd) x (B,Sk,Hkv,hd) -> (B,H,Sq,Sk) without repeating K."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, hd)
    s = torch.einsum("bqhgk,bshk->bhgqs", qg, k)
    return s.reshape(b, h, sq, s.shape[-1])


def _gqa_out(probs, v):
    """(B,H,Sq,Sk) x (B,Sk,Hkv,hd) -> (B,Sq,H,hd)."""
    b, h, sq, sk = probs.shape
    hkv = v.shape[2]
    pg = probs.reshape(b, hkv, h // hkv, sq, sk)
    o = torch.einsum("bhgqs,bshk->bqhgk", pg, v)
    return o.reshape(b, sq, h, o.shape[-1])


def attention(x: torch.Tensor, p: dict, cfg: ArchConfig,
              positions: torch.Tensor, *, return_kv: bool = False):
    """Causal self-attention, query-chunked: scores exist for
    ``cfg.attn_chunk`` queries at a time."""
    b, s_len, _ = x.shape
    hd = cfg.hd
    q, k, v = _qkv(x, p, cfg)
    if cfg.pos_embed == "rope":
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)

    scale = hd ** -0.5
    chunk = min(cfg.attn_chunk, s_len) if cfg.attn_chunk else s_len
    if s_len % chunk:
        chunk = s_len          # irregular lengths: single pass
    kpos = torch.arange(k.shape[1], device=x.device)

    def attend_chunk(qc, qpos):
        s = _gqa_scores(qc, k).to(torch.float32) * scale   # (B,H,cq,Sk)
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s,
                        -1e30)
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        return _gqa_out(pr, v)

    qpos_all = positions[0]
    o = torch.cat([attend_chunk(q[:, c0:c0 + chunk], qpos_all[c0:c0 + chunk])
                   for c0 in range(0, s_len, chunk)], dim=1)
    out = _out_proj(o, p["wo"], cfg)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# Decode attention: one new token against the KV cache.
# ---------------------------------------------------------------------------


def decode_mask(pos, s_len: int, window: int = 0,
                device=None) -> torch.Tensor:
    """Valid-slot mask (B or 1, s_len) bool for one decode step at ``pos``
    (an int, or a (B,) tensor of positions).

    Full attention: slot i valid iff i <= pos.  Windowed ring buffer: slot
    i holds absolute position pos - ((pos - i) % window); only never-
    written slots (abs < 0) are masked."""
    if torch.is_tensor(pos):
        device = pos.device
        pos = pos.reshape(-1, 1)
    else:
        pos = int(pos)                  # a host int: no copy to the device
    slots = torch.arange(s_len, device=device)[None, :]
    if window:
        return pos - torch.remainder(pos - slots, window) >= 0
    return slots <= pos


def decode_attention(x: torch.Tensor, p: dict, cfg: ArchConfig, cache: dict,
                     pos: int):
    """x (B, 1, d); cache {k, v} (B, S_max, Hkv, hd) (+ scales if radix),
    updated in place at ``pos``.  Returns (out (B, 1, d), cache)."""
    b = x.shape[0]
    hd = cfg.hd
    q, knew, vnew = _qkv(x, p, cfg)
    if cfg.pos_embed == "rope":
        posb = torch.full((b, 1), int(pos), device=x.device)
        q = rope_apply(q, posb, cfg.rope_theta)
        knew = rope_apply(knew, posb, cfg.rope_theta)
    cache = radix_lib.cache_update(cache, knew, vnew, pos, cfg)
    s_len = cache["k"].shape[1]
    valid = decode_mask(int(pos), s_len, device=x.device)
    if radix_lib.packed_attn_enabled(cfg):
        # the kernel reads the uint8 levels directly: no (B, S, Hkv, hd)
        # float K/V is materialized
        o = radix_lib.packed_decode_attention(
            q[:, 0], cache, valid.expand(b, s_len), cfg)
        o = o[:, None].to(x.dtype)                         # (B,1,H,hd)
        return _out_proj(o, p["wo"], cfg), cache
    k, v = radix_lib.cache_read(cache, cfg)
    s = _gqa_scores(q, k).to(torch.float32) * hd ** -0.5  # (B,H,1,S)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    o = _gqa_out(pr, v)                                    # (B,1,H,hd)
    return _out_proj(o, p["wo"], cfg), cache


# ---------------------------------------------------------------------------
# Channel mixing: dense FFN variants.
# ---------------------------------------------------------------------------


def ffn(x: torch.Tensor, p: dict, cfg: ArchConfig) -> torch.Tensor:
    """Gated FFN (SwiGLU or GeGLU; ``jax.nn.gelu``'s tanh form)."""
    matmul = functools.partial(radix_lib.maybe_radix_matmul, cfg=cfg)
    if cfg.act not in ("swiglu", "geglu"):
        raise NotImplementedError(f"act={cfg.act!r} is not ported yet")
    g = matmul(x, p["w_gate"])
    u = matmul(x, p["w_up"])
    h = (F.silu(g) if cfg.act == "swiglu"
         else F.gelu(g, approximate="tanh")) * u
    return matmul(h, p["w_down"])
