"""The work of one radix kernel call: the bytes it must move and the
operations it must do, and the notes an op analysis takes of it.

One reckoning for every reader: ``chip_smoke.py``'s bound of a kernel
call, and ``launch/op_analysis``, whose roofline reads a whole step.
Bytes count each input read once and each output written once; where
the kernel's work depends on the data, the caller may pass what its data
needs (decode attention's valid slots).

The kernels are bound with ``ctypes``, so no dispatch mode sees them, and
under fake tensors they cannot run at all.  Each kernel wrapper and its
plain version (``kernels/radix_*.py``, ``spike_encode.py``, which the
public ops of ``kernels/ops.py`` and the compiled plans call) therefore
runs through :func:`noted` (the :func:`notes` decorator): while an
analysis is active it notes the call's :class:`Work` once and mutes the
analysis for the call, so the aten ops of a plain version (the CPU's, or
a fake tensor's) and a wrapper's call of its plain version are not
counted on top; outside an analysis it costs one falsy check.  A wrapper reckons from
the tensors it is given, so under tensor parallelism (``parallel/tp.py``)
a rank's note counts its own shard: a column- or row-parallel product's
local N or K, decode attention's local slots.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, TypeVar

__all__ = ["Work", "gemm", "quantize", "decode_attn", "encode", "noted",
           "notes", "OCC_ROW_BYTES"]

OCC_ROW_BYTES = 512
"""The ``(1, OCC_LANES)`` int32 plane-occupancy row a GEMM reads."""

R = TypeVar("R")


@dataclasses.dataclass(frozen=True)
class Work:
    """``nbytes`` moved; ``int8_ops`` at the int8 tensor-core rate and
    ``f32_ops`` outside the tensor cores."""
    kernel: str
    nbytes: float
    int8_ops: float
    f32_ops: float = 0.0

    @property
    def ops(self) -> float:
        return self.int8_ops + self.f32_ops


def gemm(kernel: str, m: int, k: int, n: int, *, x_bytes: int,
         epilogue: bool, occupancy: bool,
         out_bytes: Optional[int] = None) -> Work:
    """An (M, K) x (K, N) radix product (a conv as its implicit GEMM, with
    ``x_bytes`` its pre-padded input): one u8 x s8 product of 2·M·K·N
    operations; the levels (``x_bytes``), the int8 weights, the occupancy
    row, the output (uint8 levels under the epilogue, else int32) and the
    epilogue's bias and multiplier rows.  ``out_bytes``: the dequantize
    epilogue's float output, that many bytes a value, and its rows (a
    float32 scale a row, a float32 scale and an int32 column sum a
    column)."""
    if out_bytes is not None:
        out, rows = out_bytes * m * n, 4 * m + 8 * n
    else:
        out, rows = m * n * (1 if epilogue else 4), 8 * n if epilogue else 0
    nbytes = x_bytes + k * n + (OCC_ROW_BYTES if occupancy else 0) + out + rows
    return Work(kernel, float(nbytes), 2.0 * m * k * n)


def quantize(rows: int, cols: int, *, x_bytes: int, glu: bool) -> Work:
    """The one-pass activation quantize of (rows, cols) values held in
    ``x_bytes`` (a GLU's gate and up rows: twice that): each read once, a
    uint8 level written a value and a float32 scale a row; its float work
    (a division and a few adds and multiplies a value) counts as one
    operation a value."""
    nbytes = x_bytes * (2 if glu else 1) + rows * cols + 4 * rows
    return Work("radix_quantize", float(nbytes), 0.0, float(rows * cols))


def decode_attn(b: int, s_len: int, hkv: int, g: int, hd: int, *,
                packed: bool, q_bytes: int,
                valid: Optional[int] = None) -> Work:
    """One decode step of attention over the radix cache: the query, the
    ``valid`` (row, slot) pairs' K and V levels and scales (default every
    slot of every row and kv head), the mask and the float32 output; QK^T
    at the int8 rate and PV outside the tensor cores, 2·valid·g·hd
    operations each."""
    valid = b * s_len * hkv if valid is None else valid
    row_bytes = hd // 2 if packed else hd
    nbytes = (b * hkv * g * hd * q_bytes + valid * (2 * row_bytes + 8)
              + b * s_len + b * hkv * g * hd * 4)
    ops = 2.0 * valid * g * hd
    return Work("radix_decode_attn", float(nbytes), ops, ops)


def encode(numel: int) -> Work:
    """The spike encoder: a float32 read and a uint8 write per element,
    one operation each."""
    return Work("spike_encode", 5.0 * numel, 0.0, float(numel))


_SINKS: List = []
"""The active analyses, innermost last (``launch/op_analysis`` pushes
and pops them)."""


def noted(work: Callable[[], Work], fn: Callable[[], R]) -> R:
    """``fn()``, its ``work()`` noted by every active analysis, which
    counts nothing else while ``fn`` runs and then tracks the result's
    memory."""
    if not _SINKS:
        return fn()
    w = work()
    sinks = list(_SINKS)
    for s in sinks:
        s.note(w)
        s.muted += 1
    try:
        out = fn()
    finally:
        for s in sinks:
            s.muted -= 1
    for s in sinks:
        s.made(out)
    return out


def notes(work: Callable[..., Work]):
    """Decorate a kernel function: each call runs through :func:`noted`
    with ``work(*args, **kwargs)``, the call's :class:`Work`."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _SINKS:
                return fn(*args, **kwargs)
            return noted(lambda: work(*args, **kwargs),
                         lambda: fn(*args, **kwargs))
        return call
    return deco
