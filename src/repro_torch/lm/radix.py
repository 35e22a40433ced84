"""Radix quantization for LM serving (port of ``repro/lm/radix.py``).

The paper's radix encoding makes a T-step spike train the exact T-bit
binary expansion of an integer level.  Here it is applied to the two
dominant memory movers of LM inference:

* **Radix-quantized linear** (``maybe_radix_matmul``): FFN weights stored
  as int8 levels with per-output-channel scales; activations radix-
  quantized on the fly to T-bit unsigned levels of the affine-shifted
  value against a per-token scale.  The integer product runs through the
  radix matmul kernel (``use_kernel=True``: ``kernels.ops.radix_matmul``,
  the CUDA kernel on the card) or its plain integer product, and one
  rank-1 correction folds the shift back out.  A serving deployment keeps
  the levels K-major, ``{"qt": (..., d_out, d_in)}`` (``kmajor_weight``,
  made once at compile time), the layout the kernel reads.
* **Radix KV cache** (``cache_update`` / ``cache_read``): K/V stored as
  T-bit levels (uint8, two per byte when ``radix_kv_pack`` and T <= 4)
  with one f32 scale per (token, kv-head); ``packed_decode_attention``
  runs decode attention directly on the levels.

Unlike the reference's functional ``cache_update``, the port writes the
new token into the cache tensors in place and returns the same dict: a
copy of every layer's cache per generated token would move the whole
cache to change one slot.

Divisions by a constant divide by a tensor on the operand's device: on
CUDA a division by a host scalar becomes a multiply by its reciprocal,
which can move a level at its rounding boundary.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import encoding
from repro_torch.lm.config import ArchConfig

__all__ = ["torch_dtype", "quantize_weight", "kmajor_weight",
           "maybe_radix_matmul",
           "init_cache_entry", "cache_update", "cache_read",
           "packed_attn_enabled", "packed_decode_attention",
           "encode_cache_bulk"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of an ``ArchConfig.dtype`` name."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r} (one of "
                         f"{sorted(_DTYPES)})")
    return _DTYPES[name]


def _const(x: torch.Tensor, value, dtype=None) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``dtype`` (default ``x``'s) on ``x``'s
    device, so arithmetic with it is tensor-tensor on every device."""
    return torch.tensor(value, dtype=dtype or x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Weights: int8 levels + per-output-channel scale.
# ---------------------------------------------------------------------------


def quantize_weight(w: torch.Tensor, weight_bits: int = 8) -> dict:
    """(..., d_in, d_out) float -> {"q": int8, "scale": (..., d_out) f32}.

    Per-output-channel symmetric scales, computed in ``w``'s dtype as the
    reference does; leading (stacked-layer) dims are preserved."""
    qmax = 2 ** (weight_bits - 1) - 1
    scale = w.abs().amax(dim=-2) / _const(w, qmax)
    scale = torch.maximum(scale, _const(scale, 1e-12))
    q = torch.clamp(torch.round(w / scale.unsqueeze(-2)), -qmax, qmax)
    return {"q": q.to(torch.int8), "scale": scale.to(torch.float32)}


def kmajor_weight(w: dict) -> dict:
    """A :func:`quantize_weight` dict with its levels K-major:
    ``{"qt": (..., d_out, d_in) int8, "scale"}`` — the radix matmul
    kernel's layout, in place of (not beside) ``"q"``."""
    return {"qt": w["q"].transpose(-1, -2).contiguous(),
            "scale": w["scale"]}


def _radix_activation(x: torch.Tensor, num_steps: int):
    """Signed activation -> (uint8 radix levels, per-token f32 scale):
    levels of the affine-shifted value ``(x / s + 1) / 2`` in [0, 1]."""
    lvl = encoding.max_level(num_steps)
    s = x.abs().amax(dim=-1, keepdim=True).to(torch.float32) + 1e-9
    u = (x.to(torch.float32) / s + 1.0) * 0.5
    q = torch.clamp(torch.round(u * lvl), 0, lvl).to(torch.uint8)
    return q, s


def _int_product(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """(..., K) levels @ (K, N) int8 -> int32, the plain integer product
    (float64 products and sums, exact below 2^53)."""
    return torch.matmul(qx.to(torch.float64),
                        qw.to(torch.float64)).to(torch.int32)


def maybe_radix_matmul(x: torch.Tensor, w, *, cfg: ArchConfig,
                       use_kernel=None) -> torch.Tensor:
    """x (..., d_in) @ w -> (..., d_out).

    ``w`` is a plain tensor (exact mode) or a :func:`quantize_weight` /
    :func:`kmajor_weight` dict (radix serving), where

        y = (2/lvl * q_x - 1) s_x  @  q_w s_w
          = s_x * s_w * (2/lvl * (q_x @ q_w) - colsum(q_w))

    is one integer product over packed radix levels plus a rank-1
    correction.  ``use_kernel`` (default ``cfg.use_kernel``) routes the
    product through ``kernels.ops.radix_matmul`` in the
    ``cfg.kernel_dataflow`` schedule (the CUDA kernel on a CUDA tensor);
    otherwise the plain integer product runs.  Both give the same int32
    accumulator.  ``cfg.kernel_autotune`` runs the kernel at the tuned
    launch (``kernels.autotune``'s winner for the problem, swept on a
    miss)."""
    if not isinstance(w, dict):
        return torch.einsum("...d,df->...f", x, w)
    if use_kernel is None:
        use_kernel = cfg.use_kernel
    t = cfg.radix_steps
    lvl = encoding.max_level(t)
    qx, sx = _radix_activation(x, t)
    kmajor = "qt" in w
    qw, sw = (w["qt"] if kmajor else w["q"]), w["scale"]
    if use_kernel:
        from repro_torch.kernels import ops as kops
        acc = kops.radix_matmul(qx, qw, None, t, method=cfg.kernel_dataflow,
                                kmajor=kmajor, autotune=cfg.kernel_autotune)
    else:
        acc = _int_product(qx, qw.transpose(-1, -2) if kmajor else qw)
    colsum = qw.sum(dim=-1 if kmajor else -2, dtype=torch.int32)
    y = (2.0 / lvl) * acc.to(torch.float32) - colsum.to(torch.float32)
    y = y * sx * sw
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache: exact or radix uint8 levels + per-(token, head) scales.
# ---------------------------------------------------------------------------


def _radix_kv(cfg: ArchConfig) -> bool:
    return cfg.quant == "radix" and cfg.radix_kv


def _packed(cfg: ArchConfig) -> bool:
    """Two T-bit levels per byte (T <= 4)."""
    return _radix_kv(cfg) and cfg.radix_kv_pack and cfg.radix_steps <= 4


def init_cache_entry(cfg: ArchConfig, batch: int, length: int, dtype,
                     device=None) -> dict:
    """Zeros cache for one attention layer (length = S_max or window)."""
    kv = (batch, length, cfg.n_kv_heads, cfg.hd)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if _radix_kv(cfg):
        kvq = kv[:3] + (cfg.hd // 2,) if _packed(cfg) else kv
        return {"k": zeros(kvq, torch.uint8), "v": zeros(kvq, torch.uint8),
                "k_scale": zeros(kv[:3], torch.float32),
                "v_scale": zeros(kv[:3], torch.float32)}
    return {"k": zeros(kv, dtype), "v": zeros(kv, dtype)}


def _pack4(q: torch.Tensor) -> torch.Tensor:
    """(..., hd) uint8 levels < 16 -> (..., hd // 2): hi nibble = even idx."""
    return ((q[..., 0::2] << 4) | (q[..., 1::2] & 0xF)).to(torch.uint8)


def _unpack4(p: torch.Tensor) -> torch.Tensor:
    hi = (p >> 4) & 0xF
    lo = p & 0xF
    return torch.stack([hi, lo], dim=-1).reshape(p.shape[:-1] + (-1,))


def _encode_kv(x: torch.Tensor, num_steps: int):
    """(B, S, H, hd) signed -> levels uint8 + scale (B, S, H)."""
    lvl = encoding.max_level(num_steps)
    s = x.abs().amax(dim=-1).to(torch.float32) + 1e-9
    u = (x.to(torch.float32) / s[..., None] + 1.0) * 0.5
    q = torch.clamp(torch.round(u * lvl), 0, lvl).to(torch.uint8)
    return q, s


def _decode_kv(q: torch.Tensor, s: torch.Tensor, num_steps: int, dtype):
    lvl = encoding.max_level(num_steps)
    x = (q.to(torch.float32) * (2.0 / lvl) - 1.0) * s[..., None]
    return x.to(dtype)


def cache_update(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int, cfg: ArchConfig, *, window: int = 0) -> dict:
    """Write one token (B, 1, Hkv, hd) at slot ``pos`` (the ring slot
    ``pos % window`` if windowed), in place; returns ``cache``."""
    slot = int(pos) % window if window else int(pos)
    if _radix_kv(cfg):
        qk, sk = _encode_kv(k_new, cfg.radix_steps)
        qv, sv = _encode_kv(v_new, cfg.radix_steps)
        if _packed(cfg):
            qk, qv = _pack4(qk), _pack4(qv)
        updates = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    else:
        updates = {"k": k_new, "v": v_new}
    for name, val in updates.items():
        cache[name][:, slot:slot + 1] = val.to(cache[name].dtype)
    return cache


def cache_read(cache: dict, cfg: ArchConfig,
               dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    dtype = dtype or torch_dtype(cfg.dtype)
    if _radix_kv(cfg):
        qk, qv = cache["k"], cache["v"]
        if _packed(cfg):
            qk, qv = _unpack4(qk), _unpack4(qv)
        k = _decode_kv(qk, cache["k_scale"], cfg.radix_steps, dtype)
        v = _decode_kv(qv, cache["v_scale"], cfg.radix_steps, dtype)
        return k, v
    return cache["k"], cache["v"]


def packed_attn_enabled(cfg: ArchConfig) -> bool:
    """True when decode attention runs directly on the quantized cache
    (``kernels.ops.radix_decode_attention``) instead of dequantize +
    softmax; needs the radix KV cache."""
    return _radix_kv(cfg) and cfg.packed_attn


def packed_decode_attention(q: torch.Tensor, cache: dict, mask: torch.Tensor,
                            cfg: ArchConfig) -> torch.Tensor:
    """One decode step of attention over the quantized KV cache.

    q (B, H, hd) float, ``cache`` the radix dict, ``mask`` (B, S) bool ->
    (B, H, hd) f32.  No dequantized K/V is materialized.  Routing mirrors
    :func:`maybe_radix_matmul`: ``cfg.use_kernel`` runs the kernel (the
    CUDA kernel on a CUDA tensor), otherwise its plain version.
    ``cfg.kernel_autotune`` takes the tuned KV split, on the plain path
    too, so that the two repeat one float order."""
    from repro_torch.kernels import ops as kops

    config = None if cfg.use_kernel else kops.KernelConfig(impl="plain")
    return kops.radix_decode_attention(
        q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
        mask, cfg.radix_steps, packed=_packed(cfg),
        method=cfg.kernel_dataflow, autotune=cfg.kernel_autotune,
        config=config)


def encode_cache_bulk(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig,
                      dtype) -> dict:
    """Prefill: whole-sequence K/V -> cache dict (radix or exact)."""
    if _radix_kv(cfg):
        qk, sk = _encode_kv(k, cfg.radix_steps)
        qv, sv = _encode_kv(v, cfg.radix_steps)
        if _packed(cfg):
            qk, qv = _pack4(qk), _pack4(qv)
        return {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    return {"k": k.to(dtype), "v": v.to(dtype)}
