"""Operations and bytes of one radix kernel call (a copy of the port's
``kernels/work.py`` reckoning, kept here as the benchmark's own).

Bytes count each input read once and each output written once; the least
time of a call is the larger of its bytes over the HBM bandwidth and its
operations over the int8 tensor-core peak."""

from __future__ import annotations

import dataclasses

from bench.work import peaks

OCC_ROW_BYTES = 512
"""The ``(1, OCC_LANES)`` int32 plane-occupancy row a CNN plan's GEMM reads."""


@dataclasses.dataclass(frozen=True)
class Call:
    kernel: str
    nbytes: float
    ops: float

    @property
    def least_s(self) -> float:
        return max(self.ops / peaks.INT8_OPS_PER_S,
                   self.nbytes / peaks.HBM_BYTES_PER_S)


def gemm(kernel: str, m: int, k: int, n: int, *, x_bytes: int,
         epilogue: bool, occupancy: bool) -> Call:
    """An (M, K) x (K, N) radix product (a conv as its implicit GEMM, with
    ``x_bytes`` its pre-padded uint8 input): 2·M·K·N operations; the
    levels, the int8 weights, the occupancy row, the output (uint8 levels
    under the fused epilogue, else int32) and the epilogue's bias and
    multiplier rows."""
    nbytes = (x_bytes + k * n + (OCC_ROW_BYTES if occupancy else 0)
              + m * n * (1 if epilogue else 4) + (8 * n if epilogue else 0))
    return Call(kernel, float(nbytes), 2.0 * m * k * n)
