"""Decode attention over the radix KV cache: the CUDA kernel wrapper, its
plain version and the shared algebra.

Port of ``repro/kernels/radix_attn.py:radix_decode_attn_pallas``.  One
decode step of attention reads the cache's T-bit levels directly: the
query is radix-quantized (``quantize_q``, ``Q_BITS`` = 7), the QK^T
contraction is an integer dot (one fused pass, or T occupancy-gated
K-plane passes), ``plane_scores`` folds the affine shifts, the per-token
k-scales and ``hd**-0.5`` back in, and a streaming softmax
(``osm_update``) folds the per-token v-scales into the probabilities so
the value sum is again plane algebra.  No dequantized float K/V is ever
materialized.

Unlike the Pallas kernel, a nibble-packed cache unpacks in natural order
(even dim = hi nibble, as ``lm/radix._pack4`` packs), so neither the
``[even | odd]`` query permutation nor the output's inverse permutation
exists here: the contraction does not depend on the order.

:func:`radix_decode_attn_plain` is the counterpart of the reference's XLA
twin ``ops._xla_decode_attn`` (blockwise over the cache through the same
``osm_*`` core).  :func:`radix_decode_attn_cuda` dispatches on the device
of its input: a CPU tensor runs the plain version, a CUDA tensor launches
``csrc/radix_attn.cu`` on the current stream (counted in
``radix_decode_attn_cuda.launches``) or raises.  What bounds the kernel
on the card is in the source note of the ``.cu`` file.

The integer parts are exact.  The float part follows one order in both
the kernel and the plain version: 32-slot tiles (``SLOTS``), every sum
over a tile's slots a pairwise tree (``tree_sum``, the order of a warp's
butterfly reduction), one rounding per multiply and add.  On the card
the two agree bit for bit.  That matters because a bf16 radix LM
amplifies float reassociation: a last-bit change in one attention output
can round a bf16 activation the other way and then move T-bit levels in
every later layer, so two sum orders give visibly different logits
(PERF.md).  Against the reference, whose XLA twin sums 128-slot blocks
in its own order, they agree to f32 rounding (the reference's bar:
3e-5).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.radix_matmul import OCC_LANES, gated, occ_mask

__all__ = [
    "Q_BITS",
    "MASKED",
    "SLOTS",
    "tree_sum",
    "quantize_q",
    "plane_scores",
    "osm_init",
    "osm_update",
    "osm_finalize",
    "unpack_levels",
    "radix_decode_attn_plain",
    "radix_decode_attn_cuda",
]

Q_BITS = 7
"""Decode-query quantization bits: 127 levels, so ``<qq, qk>`` is exact in
int32 for every cache T <= 8."""

MASKED = -1e30
"""Masked-score fill value: finite (not -inf), so the running max is always
defined and an all-masked block rescales by exp(0) with hard-zeroed
probabilities instead of NaN."""

SLOTS = 32
"""KV slots per tile of the streaming softmax, in the CUDA kernel (one per
lane of a warp, ``csrc/radix_attn.cu``) and the plain version alike."""

_SMEM_MAX = 232_448          # dynamic shared memory a Hopper block may use
_VOID, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_VOID] * 10 + [_INT] * 8 + [_FLOAT] * 6 + [_VOID])


def quantize_q(q: torch.Tensor, q_bits: int = Q_BITS):
    """Signed query -> (int32 radix levels, per-row f32 scale ``(..., 1)``).

    The affine shift of ``lm/radix._radix_activation``: ``u = (x/s + 1)/2``
    against the row's absmax, rounded half to even (``torch.round``)."""
    qlvl = (1 << q_bits) - 1
    s = q.abs().amax(dim=-1, keepdim=True).to(torch.float32) + 1e-9
    u = (q.to(torch.float32) / s + 1.0) * 0.5
    lv = torch.clamp(torch.round(u * qlvl), 0, qlvl).to(torch.int32)
    return lv, s


def plane_scores(sint, qsum, ksum, qs, sk, *, hd: int, num_steps: int,
                 q_bits: int) -> torch.Tensor:
    """Fold the affine shifts and per-token scales out of the integer dot.

    ``sint`` (..., g, blk) int32 = <qq, qk>; ``qsum`` the query level sums
    (..., g, 1); ``ksum`` the key level sums broadcastable over (..., g,
    blk); ``qs``/``sk`` the query and key scales likewise.  ``hd`` is the
    true head dim.  Includes the ``hd**-0.5`` attention scale; the op
    order is the reference's, constants rounded to f32 from double."""
    lvl = (1 << num_steps) - 1
    qlvl = (1 << q_bits) - 1
    raw = ((4.0 / (qlvl * lvl)) * sint.to(torch.float32)
           - (2.0 / qlvl) * qsum.to(torch.float32)
           - (2.0 / lvl) * ksum.to(torch.float32)
           + float(hd))
    return (hd ** -0.5) * qs * sk * raw


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` as a pairwise tree, ``x[:h] + x[h:]`` halving a
    zero-padded power-of-two length: the order of a warp's butterfly
    reduction, so the kernel's sums are repeated bit for bit."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x.movedim(-1, dim)


def osm_init(shape_gl, shape_o, device=None):
    """Zero streaming state: (m, l, o) with m at the MASKED floor."""
    return (torch.full(shape_gl, MASKED, dtype=torch.float32, device=device),
            torch.zeros(shape_gl, dtype=torch.float32, device=device),
            torch.zeros(shape_o, dtype=torch.float32, device=device))


def osm_update(state, scores, mask, pv):
    """One streaming-softmax block update (``scores`` (..., g, blk) f32,
    ``mask`` boolean broadcastable over it, ``pv`` maps the un-normalized
    probabilities to the (..., g, hd) value contribution).  Masked entries
    are hard-zeroed in ``p``: when the running max sits at the MASKED
    floor, exp(score - m) would be 1 for them."""
    m, l, o = state
    s = torch.where(mask, scores, MASKED)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.where(mask, torch.exp(s - m_new), 0.0)
    l_new = l * alpha + tree_sum(p)
    o_new = o * alpha + pv(p)
    return (m_new, l_new, o_new)


def osm_finalize(state):
    """o / l, dividing by 1 where l is 0: a fully masked row returns 0."""
    _, l, o = state
    return o / torch.where(l > 0, l, torch.ones_like(l))


def unpack_levels(x: torch.Tensor, packed: bool) -> torch.Tensor:
    """uint8 cache block -> int32 levels; a packed block (two T <= 4 levels
    per byte, hi nibble first) unpacks in natural order."""
    xi = x.to(torch.int32)
    if not packed:
        return xi
    return torch.stack([(xi >> 4) & 0xF, xi & 0xF], dim=-1).reshape(
        xi.shape[:-1] + (-1,))


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, g, d) x (N, blk, d) -> (N, g, blk) int32 (float64, exact)."""
    return torch.matmul(a.to(torch.float64),
                        b.to(torch.float64).transpose(1, 2)).to(torch.int32)


def _qk_tile(qq, kb, occ, *, num_steps: int, method: str) -> torch.Tensor:
    """<qq, qk>: one pass over the (occupancy-masked) levels, or the
    occupancy-gated K-plane passes."""
    if method == "fused":
        return _bdot(qq, kb if occ is None else kb & occ_mask(occ, num_steps))
    sint = None
    for s in range(num_steps):
        part = gated(occ, s, _bdot(qq, (kb >> s) & 1)) << s
        sint = part if sint is None else sint + part
    return sint


def _pv_tile(pw, vb, occ, *, num_steps: int, method: str) -> torch.Tensor:
    """(N, g, blk) scale-folded probabilities x (N, blk, hd) value levels
    -> (N, g, hd) f32, with the QK^T plane schedule: per-slot products,
    tree-summed over the slots."""
    def dot(levels):
        return tree_sum(pw[..., None] * levels.to(torch.float32)[:, None],
                        dim=-2).squeeze(-2)

    if method == "fused":
        return dot(vb if occ is None else vb & occ_mask(occ, num_steps))
    acc = None
    for s in range(num_steps):
        part = gated(occ, s, dot((vb >> s) & 1)) * float(1 << s)
        acc = part if acc is None else acc + part
    return acc


def radix_decode_attn_plain(qq, qs, kq, ks, vq, vs, mask, occ_k, occ_v, *,
                            num_steps: int, q_bits: int = Q_BITS, hd: int,
                            method: str = "bitserial", packed: bool = False,
                            sparsity: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments as
    :func:`radix_decode_attn_cuda`), on any device: the cache in
    ``SLOTS``-slot tiles through the streaming softmax, only the current
    tile's levels unpacked, in the kernel's float order."""
    if method not in ("fused", "bitserial"):
        raise ValueError(f"unknown method {method!r}")
    n, g, _ = qq.shape
    s_len = kq.shape[1]
    lvl = (1 << num_steps) - 1
    occk = occ_k[0] if sparsity else None
    occv = occ_v[0] if sparsity else None
    qq = qq.to(torch.int32)
    qsf = qs[..., None]
    qsum = qq.sum(dim=-1, keepdim=True, dtype=torch.int32)
    state = osm_init((n, g, 1), (n, g, hd), device=qq.device)
    blk = SLOTS
    for j0 in range(0, s_len, blk):
        kb = unpack_levels(kq[:, j0:j0 + blk], packed)
        vb = unpack_levels(vq[:, j0:j0 + blk], packed)
        skb = ks[:, None, j0:j0 + blk]
        svb = vs[:, None, j0:j0 + blk]
        mb = mask[:, None, j0:j0 + blk] > 0
        sint = _qk_tile(qq, kb, occk, num_steps=num_steps, method=method)
        ksum = kb.sum(dim=-1, dtype=torch.int32)[:, None, :]
        scores = plane_scores(sint, qsum, ksum, qsf, skb, hd=hd,
                              num_steps=num_steps, q_bits=q_bits)

        def pv(p, vb=vb, svb=svb):
            pw = p * svb
            vint = _pv_tile(pw, vb, occv, num_steps=num_steps, method=method)
            return (2.0 / lvl) * vint - tree_sum(pw)

        state = osm_update(state, scores, mb, pv)
    return osm_finalize(state)


def _f32(v: float) -> float:
    """``v`` rounded to float32 (JAX's weak-typed Python constants)."""
    return float(torch.tensor(v, dtype=torch.float32))


def smem_bytes(g: int, hd: int) -> int:
    """Dynamic shared memory of one kernel block (``csrc/radix_attn.cu``):
    query levels and the output accumulator (g x hd4 words each), the
    score tile, per-head and per-slot rows, and the K and V tiles."""
    hd4 = -(-hd // 4) * 4
    words = 2 * g * hd4 + g * SLOTS + 6 * g + 3 * SLOTS
    return 4 * words + 2 * SLOTS * (hd4 + 4)


def radix_decode_attn_cuda(qq: torch.Tensor, qs: torch.Tensor,
                           kq: torch.Tensor, ks: torch.Tensor,
                           vq: torch.Tensor, vs: torch.Tensor,
                           mask: torch.Tensor, occ_k: Optional[torch.Tensor],
                           occ_v: Optional[torch.Tensor], *, num_steps: int,
                           q_bits: int = Q_BITS, hd: int,
                           method: str = "bitserial", packed: bool = False,
                           sparsity: bool = True) -> torch.Tensor:
    """One decode step over the radix cache, (N = B*Hkv)-row layout.

    ``qq`` (N, g, hd) int32 query levels, ``qs`` (N, g) f32 query scales,
    ``kq``/``vq`` (N, S, hd or hd/2) uint8 levels (``packed``: two nibbles
    per byte, hi first), ``ks``/``vs`` (N, S) f32 per-token scales,
    ``mask`` (N, S) int32 (1 = attend), ``occ_k``/``occ_v`` (1, OCC_LANES)
    int32 occupancy rows (read when ``sparsity``).  Returns (N, g, hd)
    f32.  Any S: the kernel masks its ragged last tile itself.

    CPU tensors run :func:`radix_decode_attn_plain`; CUDA tensors launch
    the kernel or raise."""
    kw = dict(num_steps=num_steps, q_bits=q_bits, hd=hd, method=method,
              packed=packed, sparsity=sparsity)
    if qq.device.type == "cpu":
        return radix_decode_attn_plain(qq, qs, kq, ks, vq, vs, mask, occ_k,
                                       occ_v, **kw)
    if qq.device.type != "cuda":
        raise ValueError(f"radix_decode_attn runs on CPU or CUDA, got "
                         f"{qq.device}")
    dev = qq.device
    if method not in ("fused", "bitserial"):
        raise ValueError(f"unknown method {method!r}")
    if not 1 <= num_steps <= (4 if packed else 8):
        raise ValueError(f"num_steps must be in [1, {4 if packed else 8}] "
                         f"for a {'packed ' if packed else ''}uint8 cache, "
                         f"got {num_steps}")
    if not 1 <= q_bits <= 8:
        raise ValueError(f"q_bits must be in [1, 8], got {q_bits}")
    _build.check_tensor(qq, "qq", (torch.int32,), dev, 3)
    n, g, hdq = qq.shape
    if hdq != hd or (packed and hd % 2):
        raise ValueError(f"qq head dim {hdq} vs hd={hd} (packed={packed})")
    hdp = hd // 2 if packed else hd
    _build.check_tensor(qs, "qs", (torch.float32,), dev, 2)
    for name, t in (("kq", kq), ("vq", vq)):
        _build.check_tensor(t, name, (torch.uint8,), dev, 3)
        if t.shape[0] != n or t.shape[2] != hdp:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit "
                             f"(N={n}, S, {hdp})")
    s_len = kq.shape[1]
    if vq.shape[1] != s_len:
        raise ValueError(f"kq and vq disagree on S: {kq.shape[1]} vs "
                         f"{vq.shape[1]}")
    for name, t, dt in (("ks", ks, torch.float32), ("vs", vs, torch.float32),
                        ("mask", mask, torch.int32)):
        _build.check_tensor(t, name, (dt,), dev, 2)
        if tuple(t.shape) != (n, s_len):
            raise ValueError(f"{name} must be {(n, s_len)}, got "
                             f"{tuple(t.shape)}")
    if tuple(qs.shape) != (n, g):
        raise ValueError(f"qs must be {(n, g)}, got {tuple(qs.shape)}")
    occ_ptrs = [None, None]
    if sparsity:
        for i, (name, t) in enumerate((("occ_k", occ_k), ("occ_v", occ_v))):
            _build.check_tensor(t, name, (torch.int32,), dev, 2)
            if tuple(t.shape) != (1, OCC_LANES):
                raise ValueError(f"{name} must be (1, {OCC_LANES}), got "
                                 f"{tuple(t.shape)}")
            occ_ptrs[i] = t.data_ptr()
    smem = smem_bytes(g, hd)
    if smem > _SMEM_MAX:
        raise ValueError(f"g={g}, hd={hd} needs {smem} bytes of shared "
                         f"memory per block, over the card's {_SMEM_MAX}")
    out = torch.empty((n, g, hd), dtype=torch.float32, device=dev)
    if n == 0 or g == 0 or s_len == 0:
        return out.zero_()
    lvl = (1 << num_steps) - 1
    qlvl = (1 << q_bits) - 1
    fn = _build.function("radix_attn", "radix_decode_attn_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(qq.data_ptr(), qs.data_ptr(), kq.data_ptr(), ks.data_ptr(),
                  vq.data_ptr(), vs.data_ptr(), mask.data_ptr(), occ_ptrs[0],
                  occ_ptrs[1], out.data_ptr(),
                  n, g, s_len, hd, int(packed), num_steps,
                  int(method == "fused"), smem,
                  _f32(4.0 / (qlvl * lvl)), _f32(2.0 / qlvl),
                  _f32(2.0 / lvl), _f32(float(hd)), _f32(hd ** -0.5),
                  _f32(2.0 / lvl),
                  torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise _build.launch_error("radix_decode_attn", code)
    radix_decode_attn_cuda.launches += 1
    return out


radix_decode_attn_cuda.launches = 0
