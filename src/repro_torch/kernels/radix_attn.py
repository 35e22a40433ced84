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

Both functions take what the LM holds: the float query, the cache in its
(B, S, Hkv, ·) layout and the (B, S) bool mask.  The cache is cut into
KV splits of :func:`split_slots` slots (``SPLIT_SLOTS``, more past
``MAX_SPLITS`` splits), each split runs the streaming softmax over its
32-slot tiles (``SLOTS``) from a fresh state, and :func:`combine_splits`
merges the splits' (m, l, o).  A nibble-packed cache unpacks in natural
order (even dim = hi nibble, as ``lm/radix._pack4`` packs), so neither
the reference's ``[even | odd]`` query permutation nor the output's
inverse permutation exists here.

:func:`radix_decode_attn_plain` is the counterpart of the reference's XLA
twin ``ops._xla_decode_attn``; it gates its plane passes on the whole
cache's occupancy row, as the reference does.  :func:`radix_decode_attn_cuda`
dispatches on the device of its input: a CPU tensor runs the plain
version, a CUDA tensor launches ``csrc/radix_attn.cu`` on the current
stream (counted in ``radix_decode_attn_cuda.launches``) or raises.  The
kernel quantizes the query, reads the mask and gates each tile on its
own occupancy itself.  Gating a plane pass on any superset of the
planes a tile occupies gives the same bits as not gating (an empty
plane adds exactly +0), so the two agree.  What bounds the kernel on the
card is in the source note of the ``.cu`` file.

The integer parts are exact.  The float part follows one order in both
the kernel and the plain version: 32-slot tiles, every sum over a tile's
slots or over the splits a pairwise tree (``tree_sum``, the order of a
warp's butterfly reduction), one rounding per multiply and add.  On the
card the two agree bit for bit.  That matters because a bf16 radix LM
amplifies float reassociation: a last-bit change in one attention output
can round a bf16 activation the other way and then move T-bit levels in
every later layer, so two sum orders give visibly different logits
(PERF.md).  Against the reference, whose XLA twin sums 128-slot blocks
in its own order, they agree to f32 rounding (the reference's bar:
3e-5).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.radix_matmul import (gated, occ_mask,
                                              plane_occupancy)

__all__ = [
    "Q_BITS",
    "MASKED",
    "SLOTS",
    "SPLIT_SLOTS",
    "MAX_SPLITS",
    "split_slots",
    "smem_bytes",
    "tree_sum",
    "quantize_q",
    "plane_scores",
    "osm_init",
    "osm_update",
    "osm_finalize",
    "unpack_levels",
    "occupancy_rows",
    "combine_splits",
    "partials_size",
    "unpack_partials",
    "merge_partials",
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

SPLIT_SLOTS = 32
"""Slots per KV split (a whole number of tiles): one kernel block per
(batch, kv-head, split).  Chosen by measurement on the card (PERF.md)."""

MAX_SPLITS = 32
"""At most this many splits per row: past ``SPLIT_SLOTS * MAX_SPLITS``
slots the splits grow by whole ``SPLIT_SLOTS`` steps, so the combine
stays small at long contexts.  Like ``SPLIT_SLOTS`` it depends on no
device, so the plain version repeats the split on the CPU.  Both are the
untuned launch: a call may name others (``splits=``, the tuner's
``KernelConfig.split_slots``/``max_splits``), and the plain version then
splits alike."""

KERNEL_MAX_SPLITS = 32
"""The most splits a row the kernel's combine takes (``MAX_LOG_SPLITS``)."""
MAX_SMEM = 232448
"""Shared memory one block of the kernel can use on the card (227 KB)."""
_DIMS = ("hkv", "g", "s_len", "hd", "steps", "gate", "qlvl", "split",
         "nsplit", "vec16", "packed", "fused", "qbf16",
         "q_b", "q_h", "k_b", "k_s", "k_h", "v_b", "v_s", "v_h",
         "ks_b", "ks_s", "ks_h", "vs_b", "vs_s", "vs_h", "m_b", "m_s",
         "rows", "partials")
"""The int64 parameter row of ``radix_decode_attn_launch``, in order
(strides in elements of each tensor)."""
_VOID = ctypes.c_void_p
_ARGTYPES = ([_VOID] * 9 + [ctypes.POINTER(ctypes.c_longlong),
                            ctypes.POINTER(ctypes.c_float), _VOID])


def split_slots(s_len: int, slots: Optional[int] = None,
                max_splits: Optional[int] = None) -> int:
    """Slots per KV split for a cache of ``s_len`` slots: ``slots``
    (default ``SPLIT_SLOTS``), or the least multiple of it that needs at
    most ``max_splits`` (default ``MAX_SPLITS``) splits.  ``s_len <=
    slots`` gives one split."""
    slots, max_splits = check_splits(slots, max_splits)
    units = -(-max(s_len, 1) // slots)
    return slots * -(-units // max_splits)


def check_splits(slots: Optional[int], max_splits: Optional[int]
                 ) -> Tuple[int, int]:
    """``(slots, max_splits)`` with the module defaults filled in, or
    ValueError: slots a positive multiple of ``SLOTS``, at most
    ``KERNEL_MAX_SPLITS`` splits."""
    slots = SPLIT_SLOTS if slots is None else int(slots)
    max_splits = MAX_SPLITS if max_splits is None else int(max_splits)
    if slots < SLOTS or slots % SLOTS:
        raise ValueError(f"split slots must be a positive multiple of "
                         f"{SLOTS}, got {slots}")
    if not 1 <= max_splits <= KERNEL_MAX_SPLITS:
        raise ValueError(f"max_splits must be in [1, {KERNEL_MAX_SPLITS}], "
                         f"got {max_splits}")
    return slots, max_splits


def smem_bytes(g: int, hd: int, packed: bool, split: int) -> int:
    """Shared memory of one kernel block (``radix_decode_attn_launch``'s
    sum): two K/V tile buffers, per query head its levels, probabilities,
    ``o`` and state, and one valid-slot word per tile of the split."""
    hdp = hd // 2 if packed else hd
    nch = -(-hdp // 16)
    buf = 2 * SLOTS * ((nch | 1) * 16) + 2 * SLOTS * 4
    per_head = nch * 16 * (2 if packed else 1) + SLOTS * 4 + hd * 4 + 16
    combine = 8 * 2 * 4 * KERNEL_MAX_SPLITS
    return max(2 * buf + g * per_head + (split // SLOTS) * 4, combine)


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


def nibble_union(levels: torch.Tensor) -> torch.Tensor:
    """Per-byte OR of hi/lo nibbles: the occupancy view of a packed cache
    (its planes' union equals the unpacked levels')."""
    return (levels >> 4) | (levels & 0xF)


def occupancy_rows(k_q: torch.Tensor, v_q: torch.Tensor, num_steps: int,
                   packed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole cache's ``(1, OCC_LANES)`` plane-occupancy rows for K and V
    (``plane_occupancy``; over ``nibble_union`` when packed), the gate the
    reference's kernel reads."""
    def row(x):
        return plane_occupancy(nibble_union(x) if packed else x,
                               num_steps)[0]

    return row(k_q), row(v_q)


def _attend_split(qq, qs, qsum, kq, ks, vq, vs, mask, occk, occv, *,
                  num_steps: int, q_bits: int, hd: int, method: str,
                  packed: bool):
    """Each row's streaming-softmax state (m, l, o), un-normalized (a row
    is one KV split): its ``SLOTS``-slot tiles in order from
    :func:`osm_init`, only the current tile's levels unpacked, in the
    kernel's float order.  ``qq`` (N, g, hd) int32, ``qs``/``qsum`` (N,
    g, 1); the splits' ``kq``/``vq`` (N, s, hdp) uint8, ``ks``/``vs``
    (N, s) f32, ``mask`` (N, s) bool."""
    n, g, _ = qq.shape
    lvl = (1 << num_steps) - 1
    state = osm_init((n, g, 1), (n, g, hd), device=qq.device)
    for j0 in range(0, kq.shape[1], SLOTS):
        kb = unpack_levels(kq[:, j0:j0 + SLOTS], packed)
        vb = unpack_levels(vq[:, j0:j0 + SLOTS], packed)
        skb = ks[:, None, j0:j0 + SLOTS]
        svb = vs[:, None, j0:j0 + SLOTS]
        mb = mask[:, None, j0:j0 + SLOTS]
        sint = _qk_tile(qq, kb, occk, num_steps=num_steps, method=method)
        ksum = kb.sum(dim=-1, dtype=torch.int32)[:, None, :]
        scores = plane_scores(sint, qsum, ksum, qs, skb, hd=hd,
                              num_steps=num_steps, q_bits=q_bits)

        def pv(p, vb=vb, svb=svb):
            pw = p * svb
            vint = _pv_tile(pw, vb, occv, num_steps=num_steps, method=method)
            return (2.0 / lvl) * vint - tree_sum(pw)

        state = osm_update(state, scores, mb, pv)
    return state


def combine_splits(m: torch.Tensor, l: torch.Tensor,
                   o: torch.Tensor) -> torch.Tensor:
    """Merge per-split softmax states into the output: ``m``/``l`` (N,
    splits, g, 1), ``o`` (N, splits, g, hd) un-normalized.  m = max over
    the splits; l and o are pairwise trees (``tree_sum``, zero-padded)
    of l_i * exp(m_i - m) and o_i * exp(m_i - m); then o / l, or o where
    l is 0.  One split passes through bit for bit (exp(0) = 1)."""
    mx = m.amax(dim=1, keepdim=True)
    e = torch.exp(m - mx)
    state = (mx, tree_sum(l * e, dim=1), tree_sum(o * e, dim=1))
    return osm_finalize(state).squeeze(1)


def partials_size(n: int, nsplit: int, g: int, hd: int) -> int:
    """f32 elements of one call's partials (``partials=True``): the
    splits' un-normalized ``o`` (N, splits, g, hd), then their (m, l)
    (N, splits, g, 2), N = B * Hkv rows."""
    return n * nsplit * g * (hd + 2)


def unpack_partials(part: torch.Tensor, n: int, g: int, hd: int):
    """(m, l, o) views of a flat partials buffer: ``m``/``l`` (N, splits,
    g, 1), ``o`` (N, splits, g, hd), as :func:`combine_splits` takes
    them."""
    nsplit = part.numel() // (n * g * (hd + 2))
    cut = n * nsplit * g * hd
    o = part[:cut].view(n, nsplit, g, hd)
    ml = part[cut:].view(n, nsplit, g, 2)
    return ml[..., :1], ml[..., 1:], o


def merge_partials(parts, n: int, g: int, hd: int) -> torch.Tensor:
    """The output (N, g, hd) of the splits of ``parts`` (flat partials
    buffers, in slot order: one per rank of a KV sequence split over
    ranks) merged by :func:`combine_splits`, in the kernel's pairwise
    order over all of them.  Where every buffer holds the same number of
    splits of the same size, a power of two of them, the merge is the
    one-device kernel's combine of the same splits, bit for bit.  A
    buffer whose every slot was masked holds (MASKED, 0, 0) splits: they
    add exact zeros."""
    ms, ls, os_ = zip(*(unpack_partials(p, n, g, hd) for p in parts))
    return combine_splits(torch.cat(ms, 1), torch.cat(ls, 1),
                          torch.cat(os_, 1))


def _shapes(q, k_q, mask, packed: bool):
    """(B, H, hd, S, Hkv, g) of a call, or ValueError."""
    if q.ndim != 3 or k_q.ndim != 4:
        raise ValueError(f"q must be (B, H, hd) and the cache (B, S, Hkv, "
                         f"·), got {tuple(q.shape)} and {tuple(k_q.shape)}")
    b, h, hd = q.shape
    _, s_len, hkv, hdp = k_q.shape
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    if hdp != (hd // 2 if packed else hd) or (packed and hd % 2):
        raise ValueError(f"cache last dim {hdp} does not fit hd={hd} "
                         f"(packed={packed})")
    if tuple(mask.shape) != (b, s_len):
        raise ValueError(f"mask must be {(b, s_len)}, got "
                         f"{tuple(mask.shape)}")
    return b, h, hd, s_len, hkv, h // hkv


def _work(q, k_q, *_, packed: bool = False, **__) -> work.Work:
    b, h, hd = q.shape
    s_len, hkv = k_q.shape[1], k_q.shape[2]
    return work.decode_attn(b, s_len, hkv, h // max(hkv, 1), hd,
                            packed=packed, q_bytes=q.element_size())


@work.notes(_work)
def radix_decode_attn_plain(q: torch.Tensor, k_q: torch.Tensor,
                            k_scale: torch.Tensor, v_q: torch.Tensor,
                            v_scale: torch.Tensor, mask: torch.Tensor, *,
                            num_steps: int, q_bits: int = Q_BITS,
                            method: str = "bitserial", packed: bool = False,
                            sparsity: bool = True,
                            splits: Optional[Tuple[int, int]] = None,
                            occupancy: Optional[Tuple[torch.Tensor,
                                                      torch.Tensor]] = None,
                            partials: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the arguments of
    :func:`radix_decode_attn_cuda`), on any device: ``quantize_q``, the
    cache's :func:`split_slots` splits (``splits`` = ``(slots,
    max_splits)``, default the module's) through the tile loop, then
    :func:`combine_splits`.  With ``sparsity`` the plane passes are gated
    on ``occupancy`` (K and V ``(1, OCC_LANES)`` rows), by default the
    whole cache's (:func:`occupancy_rows`).

    The splits run side by side, as rows of one batch (the last one
    padded with masked, zero slots): a masked slot adds an exact 0 to
    every sum and a fully masked tile rescales by exp(0) = 1, so each
    split's state is the one the split alone would give.

    ``partials`` returns the splits' un-normalized states instead, as the
    kernel's partials mode writes them (:func:`partials_size`,
    :func:`unpack_partials`)."""
    if method not in ("fused", "bitserial"):
        raise ValueError(f"unknown method {method!r}")
    splits = check_splits(*(splits or (None, None)))
    b, h, hd, s_len, hkv, g = _shapes(q, k_q, mask, packed)
    n = b * hkv
    if n == 0 or g == 0 or s_len == 0:
        if partials:
            raise ValueError("the partials of an empty call")
        return torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    qq, qs = quantize_q(q, q_bits)
    qq = qq.reshape(n, g, hd)
    qs = qs.reshape(n, g, 1)
    qsum = qq.sum(dim=-1, keepdim=True, dtype=torch.int32)

    def seq_major(a):                     # (B, S, Hkv, ...) -> (N, S, ...)
        moved = a.movedim(2, 1)
        return moved.reshape((n,) + tuple(moved.shape[2:]))

    kq, ks, vq, vs = (seq_major(a) for a in (k_q, k_scale, v_q, v_scale))
    maskn = mask.to(torch.bool)[:, None, :].expand(b, hkv, s_len)
    maskn = maskn.reshape(n, s_len)
    occk = occv = None
    if sparsity:
        rows = occupancy if occupancy is not None else occupancy_rows(
            k_q, v_q, num_steps, packed)
        occk, occv = rows[0][0], rows[1][0]
    step = split_slots(s_len, *splits)
    nsplit = -(-s_len // step)
    pad = nsplit * step - s_len

    def split_rows(a):                # (N, S, ·) -> (N * nsplit, step, ·)
        if pad:
            a = torch.cat([a, a.new_zeros((n, pad) + tuple(a.shape[2:]))],
                          dim=1)
        return a.reshape((n * nsplit, step) + tuple(a.shape[2:]))

    def per_split(a):                 # (N, ·) -> (N * nsplit, ·)
        return a.repeat_interleave(nsplit, dim=0)

    state = _attend_split(
        per_split(qq), per_split(qs), per_split(qsum), *(
            split_rows(a) for a in (kq, ks, vq, vs, maskn)),
        occk, occv, num_steps=num_steps, q_bits=q_bits, hd=hd,
        method=method, packed=packed)
    m, l, o = (t.reshape((n, nsplit) + tuple(t.shape[1:])) for t in state)
    if partials:
        return torch.cat([o.reshape(-1), torch.cat([m, l], -1).reshape(-1)])
    return combine_splits(m, l, o).reshape(b, h, hd)


def _f32(v: float) -> float:
    """``v`` rounded to float32 (JAX's weak-typed Python constants)."""
    return float(torch.tensor(v, dtype=torch.float32))


@functools.lru_cache(maxsize=8)
def _workspace(index: int, n: int, nsplit: int, g: int,
               hd: int) -> torch.Tensor:
    """The split states (N, splits, g, hd) o then (N, splits, g, 2) (m, l)
    as f32 bits, then one int32 arrival count per row, zeroed once: the
    last block of a row resets its count, so a cached workspace is ready
    for the next launch on the stream."""
    return torch.zeros(n * nsplit * g * (hd + 2) + n, dtype=torch.int32,
                       device=torch.device("cuda", index))


def _aligned(t: torch.Tensor, strides, size: int) -> bool:
    return t.data_ptr() % size == 0 and all(s % size == 0 for s in strides)


class _Plan:
    """What a call of one signature (devices, dtypes, shapes, strides,
    16-byte alignment, arguments, split constants) launches with: checked
    once, then reused, so a repeated call costs the launch and little
    else."""

    def __init__(self, tensors, *, num_steps: int, q_bits: int, method: str,
                 packed: bool, sparsity: bool, splits: Tuple[int, int],
                 partials: bool = False):
        q, k_q, k_scale, v_q, v_scale, mask = tensors
        dev = q.device
        if method not in ("fused", "bitserial"):
            raise ValueError(f"unknown method {method!r}")
        if not 1 <= num_steps <= (4 if packed else 8):
            raise ValueError(f"num_steps must be in [1, {4 if packed else 8}]"
                             f" for a {'packed ' if packed else ''}uint8 "
                             f"cache, got {num_steps}")
        if not 1 <= q_bits <= 8:
            raise ValueError(f"q_bits must be in [1, 8], got {q_bits}")
        b, h, hd, s_len, hkv, g = _shapes(q, k_q, mask, packed)
        hdp = k_q.shape[3]
        for name, t, dtypes, ndim in (
                ("q", q, (torch.bfloat16, torch.float32), 3),
                ("k_q", k_q, (torch.uint8,), 4),
                ("v_q", v_q, (torch.uint8,), 4),
                ("k_scale", k_scale, (torch.float32,), 3),
                ("v_scale", v_scale, (torch.float32,), 3),
                ("mask", mask, (torch.bool,), 2)):
            if t.device != dev or t.dtype not in dtypes or t.ndim != ndim:
                raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}, expected {ndim}-D of "
                                 f"{dtypes} on {dev}")
        if tuple(v_q.shape) != tuple(k_q.shape):
            raise ValueError(f"k_q {tuple(k_q.shape)} and v_q "
                             f"{tuple(v_q.shape)} differ")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != (b, s_len, hkv):
                raise ValueError(f"{name} must be {(b, s_len, hkv)}, got "
                                 f"{tuple(t.shape)}")
        if h and hdp % 4:
            raise ValueError(f"the kernel takes whole 4-byte cache words; "
                             f"got hd={hd}, packed={packed}")
        if q.stride(2) != 1 or k_q.stride(3) != 1 or v_q.stride(3) != 1:
            raise ValueError("q and the cache need contiguous head rows")
        cache_strides = k_q.stride()[:3] + v_q.stride()[:3]
        if (_aligned(k_q, cache_strides, 16) and _aligned(v_q, (), 16)
                and hdp % 16 == 0):
            vec16 = 1
        elif _aligned(k_q, cache_strides, 4) and _aligned(v_q, (), 4):
            vec16 = 0
        else:
            raise ValueError("the cache rows must start on 4-byte "
                             "boundaries")
        self.device, self.out_shape = dev, (b, h, hd)
        self.empty = b == 0 or h == 0 or s_len == 0
        split = split_slots(max(s_len, 1), *splits)
        nsplit = -(-s_len // split)
        if nsplit > KERNEL_MAX_SPLITS:
            raise ValueError(f"{nsplit} splits: the combine takes at most "
                             f"{KERNEL_MAX_SPLITS}")
        smem = smem_bytes(g, hd, packed, split)
        if h and smem > MAX_SMEM:
            raise ValueError(f"g={g} query heads of hd={hd} need {smem} "
                             f"bytes of shared memory a block, more than "
                             f"the card's {MAX_SMEM}")
        n = b * hkv
        self.work = self.count = None
        self.part_size = partials_size(n, nsplit, g, hd)
        if partials and self.empty:
            raise ValueError("the partials of an empty call")
        if nsplit > 1 and not partials:
            self.workspace = _workspace(_build.device_index(dev), n, nsplit,
                                        g, hd)
            self.work = self.workspace.data_ptr()
            self.count = self.work + 4 * n * nsplit * g * (hd + 2)
        lvl = (1 << num_steps) - 1
        qlvl = (1 << q_bits) - 1
        vals = dict(hkv=hkv, g=g, s_len=s_len, hd=hd, steps=num_steps,
                    gate=int(sparsity and method == "bitserial"), qlvl=qlvl,
                    split=split, nsplit=nsplit, vec16=vec16,
                    packed=int(packed), fused=int(method == "fused"),
                    qbf16=int(q.dtype == torch.bfloat16), rows=n,
                    partials=int(partials))
        for name, t in (("q", q), ("k", k_q), ("v", v_q), ("ks", k_scale),
                        ("vs", v_scale), ("m", mask)):
            for axis, st in zip("bh" if name == "q" else "bsh", t.stride()):
                vals[f"{name}_{axis}"] = st
        self.dims = (ctypes.c_longlong * len(_DIMS))(*(vals[k] for k in _DIMS))
        self.consts = (ctypes.c_float * 6)(
            _f32(4.0 / (qlvl * lvl)), _f32(2.0 / qlvl), _f32(2.0 / lvl),
            _f32(float(hd)), _f32(hd ** -0.5), _f32(2.0 / lvl))
        self.fn = _build.function("radix_attn", "radix_decode_attn_launch",
                                  _ARGTYPES)


_plans: dict = {}


@work.notes(_work)
def radix_decode_attn_cuda(q: torch.Tensor, k_q: torch.Tensor,
                           k_scale: torch.Tensor, v_q: torch.Tensor,
                           v_scale: torch.Tensor, mask: torch.Tensor, *,
                           num_steps: int, q_bits: int = Q_BITS,
                           method: str = "bitserial", packed: bool = False,
                           sparsity: bool = True,
                           splits: Optional[Tuple[int, int]] = None,
                           partials: bool = False,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One decode step over the radix cache, in one launch.

    ``q`` (B, H, hd) bf16 or f32 decode queries; ``k_q``/``v_q`` (B, S,
    Hkv, hd or hd/2) uint8 levels (``packed``: two nibbles per byte, hi
    first); ``k_scale``/``v_scale`` (B, S, Hkv) f32; ``mask`` (B, S) bool
    (1 = attend).  Any strides, but each head's levels and query row are
    contiguous; a broadcast mask (stride 0) is read as it is.  Returns
    (B, H, hd) f32.  The kernel takes any number of query heads per kv
    head and any hd with a whole number of 4-byte words per cache row,
    as long as one block's shared memory (:func:`smem_bytes`) fits the
    card.  ``splits`` = ``(slots, max_splits)`` names the KV split
    (default ``(SPLIT_SLOTS, MAX_SPLITS)``); the plain version given the
    same ``splits`` repeats the launch bit for bit.

    ``partials`` is the mode of a KV sequence split over ranks: the
    launch writes each split's un-normalized (o, m, l) to ``out`` (a flat
    f32 buffer of :func:`partials_size`, made when not given) and skips
    the combine; :func:`merge_partials` merges the ranks' buffers.

    CPU tensors run :func:`radix_decode_attn_plain`; CUDA tensors launch
    the kernel or raise."""
    tensors = (q, k_q, k_scale, v_q, v_scale, mask)
    if q.device.type == "cpu":
        got = radix_decode_attn_plain(
            *tensors, num_steps=num_steps, q_bits=q_bits, method=method,
            packed=packed, sparsity=sparsity, splits=splits,
            partials=partials)
        if out is not None:
            return out.copy_(got)
        return got
    if q.device.type != "cuda":
        raise ValueError(f"radix_decode_attn runs on CPU or CUDA, got "
                         f"{q.device}")
    _build.check_real(*tensors)
    splits = check_splits(*(splits or (None, None)))
    key = (num_steps, q_bits, method, packed, sparsity, splits,
           partials) + tuple(
        (t.device, t.dtype, t.shape, t.stride(), t.data_ptr() % 16)
        for t in tensors)
    plan = _plans.get(key)
    if plan is None:
        plan = _Plan(tensors, num_steps=num_steps, q_bits=q_bits,
                     method=method, packed=packed, sparsity=sparsity,
                     splits=splits, partials=partials)
        if len(_plans) >= 64:
            _plans.clear()
        _plans[key] = plan
    dev = plan.device
    work = plan.work
    if partials:
        if out is None:
            out = torch.empty(plan.part_size, dtype=torch.float32,
                              device=dev)
        elif (out.device != dev or out.dtype != torch.float32
              or out.numel() != plan.part_size or not out.is_contiguous()
              or out.data_ptr() % 16):
            raise ValueError(f"out must be {plan.part_size} contiguous, "
                             f"16-byte aligned f32 on {dev}")
        work, result = out.data_ptr(), out
    else:
        result = torch.empty(plan.out_shape, dtype=torch.float32,
                             device=dev)
        if plan.empty:
            return result.zero_()
    with torch.cuda.device(dev):
        code = plan.fn(q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
                       v_q.data_ptr(), v_scale.data_ptr(), mask.data_ptr(),
                       result.data_ptr(), work, plan.count, plan.dims,
                       plan.consts, torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise _build.launch_error("radix_decode_attn", code)
    radix_decode_attn_cuda.launches += 1
    return result


radix_decode_attn_cuda.launches = 0
