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
* **Two paths, one result.** Where :func:`fused_path` holds (the kernel
  path on a CUDA tensor, no row-parallel ``tp``, no gradient needed),
  the product runs "fused": the one-pass quantize kernel makes the
  levels and the kernel's dequantize epilogue writes the bf16 / f32
  output.  Elsewhere it runs "int32": the int32 accumulator, then the
  float32 glue.  Both round every float the same way, so the two give
  the same bits; :data:`PRODUCTS` counts the products by path.  The
  routing lives here alone: :func:`radix_input` quantizes an input once
  for the several products that read it (a :class:`Levels`), and
  :func:`glu_input` makes a SwiGLU's or GeGLU's down-product levels from
  its gate and up outputs without writing their product; each gives the
  plain tensor where the fused path does not hold.
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

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import encoding
from repro_torch.kernels import radix_matmul as rmm
from repro_torch.kernels import work
from repro_torch.lm.config import ArchConfig

__all__ = ["torch_dtype", "quantize_weight", "kmajor_weight",
           "PRODUCTS", "Levels", "fused_path", "radix_input", "glu_input",
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


def _radix_activation(x: torch.Tensor, num_steps: int, tp=None):
    """Signed activation -> (uint8 radix levels, per-token f32 scale):
    levels of the affine-shifted value ``(x / s + 1) / 2`` in [0, 1].
    With ``tp`` (``parallel.tp.TP``) ``x`` is this rank's slice of each
    row and the absmax is a max over 'model' (exact, so the scale is the
    whole row's).  The expression is ``rmm.quantize_rows``, the one-pass
    quantize kernel's plain twin."""
    return rmm.quantize_rows(x, num_steps, None if tp is None else tp.max)


def _int_product_work(qx: torch.Tensor, qw: torch.Tensor) -> work.Work:
    k, n = qw.shape[-2:]
    return work.gemm("radix_matmul", qx.numel() // max(k, 1), k, n,
                     x_bytes=qx.numel() * qx.element_size(),
                     epilogue=False, occupancy=False)


@work.notes(_int_product_work)
def _int_product(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """(..., K) levels @ (K, N) int8 -> int32, the plain integer product
    (float64 products and sums, exact below 2^53), noted to an op
    analysis as the radix product it computes."""
    return torch.matmul(qx.to(torch.float64),
                        qw.to(torch.float64)).to(torch.int32)


PRODUCTS = {"fused": 0, "int32": 0}
"""Radix products run, by path (the module note): "fused" (one-pass
quantize, dequantize epilogue) or "int32" (int32 accumulator, float32
glue)."""


class Levels(NamedTuple):
    """An activation's radix levels for fused products: ``q`` (..., K)
    uint8, ``s`` (..., 1) float32 row scales, ``dtype`` the activation's
    dtype (the products' output dtype)."""

    q: torch.Tensor
    s: torch.Tensor
    dtype: torch.dtype


def fused_path(x: torch.Tensor, w, cfg: ArchConfig, *, use_kernel=None,
               tp=None, up: Optional[torch.Tensor] = None) -> bool:
    """Whether a radix product of ``x`` (with ``up``: a GLU's gate and up
    outputs, quantized as their product) with ``w`` takes the fused path:
    a radix weight dict, the kernel path (``use_kernel``, default
    ``cfg.use_kernel``) on a CUDA tensor whose rows the quantize kernel
    takes (``quantize_fits``: bf16 or f32), no ``tp`` (a row-parallel
    product sums its int32 accumulators over 'model' before any float),
    and no input that needs a gradient."""
    if use_kernel is None:
        use_kernel = cfg.use_kernel
    if not (isinstance(w, dict) and use_kernel and tp is None and x.is_cuda
            and rmm.quantize_fits(x.shape[-1], x.dtype)):
        return False
    grads = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, up, w["scale"]))
    return not grads


def _levels(x: torch.Tensor, cfg: ArchConfig, *,
            act: Optional[str] = None,
            up: Optional[torch.Tensor] = None) -> Levels:
    """``x``'s :class:`Levels` by the one-pass quantize kernel; ``act``
    ("swiglu" / "geglu") quantizes ``act(x) * up`` as PyTorch rounds it,
    without writing it."""
    q, s = rmm.radix_quantize_cuda(x, cfg.radix_steps, act=act, up=up)
    return Levels(q, s, x.dtype)


def radix_input(x: torch.Tensor, w, cfg: ArchConfig
                ) -> Union[torch.Tensor, Levels]:
    """``x`` as the input of radix products with weights like ``w``, none
    of them row-parallel: its :class:`Levels`, made once for them all,
    where :func:`fused_path` holds, else ``x``."""
    return _levels(x, cfg) if fused_path(x, w, cfg) else x


def glu_input(g: torch.Tensor, u: torch.Tensor, w, cfg: ArchConfig, *,
              tp=None) -> Union[torch.Tensor, Levels]:
    """A GLU's (``cfg.act``: "swiglu" / "geglu") ``act(g) * u`` as the
    input of its down product with ``w`` (row-parallel under ``tp``): the
    fused kernel's :class:`Levels` of it, the product never written, where
    :func:`fused_path` holds, else the product as a tensor."""
    if fused_path(g, w, cfg, up=u, tp=tp):
        return _levels(g, cfg, act=cfg.act, up=u)
    return rmm.glu(g, u, cfg.act)


def maybe_radix_matmul(x: Union[torch.Tensor, Levels], w, *,
                       cfg: ArchConfig, use_kernel=None,
                       tp=None) -> torch.Tensor:
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
    miss).

    Where :func:`fused_path` holds, the levels come from the one-pass
    quantize kernel and the kernel's dequantize epilogue turns the
    accumulator into ``x.dtype`` in the float32 glue's order.  ``x`` may
    be :class:`Levels` (:func:`radix_input`, :func:`glu_input`), which
    take that path alone: with a plain weight, ``use_kernel`` off or a
    ``tp`` they raise ``ValueError``.  Elsewhere the int32 accumulator
    leaves the kernel and the glue (``rmm.dequantize``) runs as tensor
    code.  The two paths give the same bits (:data:`PRODUCTS` counts
    them).

    ``tp`` (a ``parallel.tp.TP``) makes the product row-parallel: ``x``
    and ``w`` are this rank's slice of the input channels and its rows of
    the weight (a column-parallel product is the plain call on this
    rank's columns).  The float product is summed over 'model'
    (``tp.exit``); a radix product quantizes against the whole row's
    scale (a max over 'model'), sums the int32 accumulators and the
    weight's column sums over 'model' (reduce-scattered over the
    sequence under ``tp.seq``) and only then turns them into float, the
    reference's order, so the result is exact on any split."""
    if use_kernel is None:
        use_kernel = cfg.use_kernel
    if isinstance(x, Levels) and not (isinstance(w, dict) and use_kernel
                                      and tp is None):
        raise ValueError("Levels take the fused path only: a radix weight "
                         "on the kernel path, not row-parallel")
    if not isinstance(w, dict):
        y = torch.einsum("...d,df->...f", x, w)
        return y if tp is None else tp.exit(y)
    t = cfg.radix_steps
    lvl = encoding.max_level(t)
    kmajor = "qt" in w
    qw, sw = (w["qt"] if kmajor else w["q"]), w["scale"]
    colsum = qw.sum(dim=-1 if kmajor else -2, dtype=torch.int32)
    if isinstance(x, Levels) or fused_path(x, w, cfg, use_kernel=use_kernel,
                                           tp=tp):
        from repro_torch.kernels import ops as kops

        lv = x if isinstance(x, Levels) else _levels(x, cfg)
        PRODUCTS["fused"] += 1
        return kops.radix_matmul(
            lv.q, qw, None, t, method=cfg.kernel_dataflow, kmajor=kmajor,
            autotune=cfg.kernel_autotune,
            dequant=rmm.Dequant(lv.s, sw, colsum, 2.0 / lvl, lv.dtype))
    PRODUCTS["int32"] += 1
    qx, sx = _radix_activation(x, t, tp)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        acc = kops.radix_matmul(qx, qw, None, t, method=cfg.kernel_dataflow,
                                kmajor=kmajor, autotune=cfg.kernel_autotune)
    else:
        acc = _int_product(qx, qw.transpose(-1, -2) if kmajor else qw)
    if tp is not None:
        acc = tp.sum_int(acc, 1 if tp.seq else None)
        colsum = tp.sum_int(colsum)
        if tp.seq:
            sx = sx.chunk(tp.n, 1)[tp.rank]
    return rmm.dequantize(acc, rmm.Dequant(sx, sw, colsum, 2.0 / lvl,
                                           x.dtype))


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
                 pos: int, cfg: ArchConfig, *, window: int = 0,
                 offset: int = 0) -> dict:
    """Write one token (B, 1, Hkv, hd) at slot ``pos`` (the ring slot
    ``pos % window`` if windowed), in place; returns ``cache``.  A cache
    holding the slots ``offset`` .. ``offset + len - 1`` (a rank's piece
    of a cache split over 'model') writes only a slot it holds."""
    slot = (int(pos) % window if window else int(pos)) - offset
    if not 0 <= slot < cache["k"].shape[1]:
        return cache
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
                            cfg: ArchConfig, *, partials: bool = False,
                            splits=None) -> torch.Tensor:
    """One decode step of attention over the quantized KV cache.

    q (B, H, hd) float, ``cache`` the radix dict, ``mask`` (B, S) bool ->
    (B, H, hd) f32.  No dequantized K/V is materialized.  Routing mirrors
    :func:`maybe_radix_matmul`: ``cfg.use_kernel`` runs the kernel (the
    CUDA kernel on a CUDA tensor), otherwise its plain version.
    ``cfg.kernel_autotune`` takes the tuned KV split, on the plain path
    too, so that the two repeat one float order.

    ``partials`` (a cache whose slots are split over 'model') returns the
    KV splits' softmax states instead, as a flat buffer
    (``kernels.radix_attn.partials_size``), cut as ``splits`` = (slots,
    max_splits) says: the splits of the whole cache, so that the ranks'
    merged states repeat the one-device kernel's combine."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import radix_attn as ra

    if partials:
        fn = ra.radix_decode_attn_cuda if cfg.use_kernel else \
            ra.radix_decode_attn_plain
        return fn(q, cache["k"], cache["k_scale"], cache["v"],
                  cache["v_scale"], mask, num_steps=cfg.radix_steps,
                  method=cfg.kernel_dataflow, packed=_packed(cfg),
                  splits=splits, partials=True)
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
