"""Plain oracles for the radix kernels (port of ``repro/kernels/ref.py``).

Each oracle spells out the radix bit-serial math plane by plane, so the
kernels and their plain versions are checked against a second
derivation.  All accumulators are int32; products go through the exact
float64 primitives of ``core.layers``.
"""

from __future__ import annotations

import torch

from repro_torch.core.encoding import pow2_floor
from repro_torch.core.layers import _int_conv, _int_matmul

__all__ = [
    "radix_matmul_ref",
    "radix_conv2d_ref",
    "requantize_ref",
    "radix_matmul_epilogue_ref",
    "radix_conv2d_epilogue_ref",
]


def _bitserial(x_q: torch.Tensor, op, num_steps: int, periods: int):
    """``sum_t 2^(T-1-t) op(plane_t)`` (Horner), or the phase schedule
    (``periods * T`` passes with weights ``2^(T-1-(t mod T))``, then
    ``// periods``)."""
    x = x_q.to(torch.int32)
    acc = None
    if periods == 1:
        for t in range(num_steps):
            part = op((x >> (num_steps - 1 - t)) & 1)
            acc = part if acc is None else (acc << 1) + part
        return acc
    for t in range(num_steps * periods):
        shift = num_steps - 1 - (t % num_steps)
        part = op((x >> shift) & 1) << shift
        acc = part if acc is None else acc + part
    return torch.div(acc, periods, rounding_mode="floor")


def radix_matmul_ref(x_q, w_q, num_steps: int, *, periods: int = 1):
    """Bit-serial matmul oracle: (M, K) levels x (K, N) int8 -> int32."""
    return _bitserial(x_q, lambda p: _int_matmul(p, w_q), num_steps, periods)


def radix_conv2d_ref(x_q, w_q, num_steps: int, *, stride: int = 1,
                     periods: int = 1):
    """Bit-serial strided VALID conv oracle (NHWC x HWIO -> NHWC int32)."""
    return _bitserial(x_q, lambda p: _int_conv(p, w_q, stride, "VALID"),
                      num_steps, periods)


def requantize_ref(acc, num_steps: int, mult, *, grid: str = "dense"):
    """Output logic: ``clip(floor(f32(acc) * mult), 0, 2^T - 1)``, then
    ``pow2_floor`` for ``grid="pow2"``; uint8 out."""
    lvl = (1 << num_steps) - 1
    mult = torch.as_tensor(mult, dtype=torch.float32, device=acc.device)
    q = torch.floor(acc.to(torch.float32) * mult)
    q = torch.clamp(q, 0, lvl).to(torch.int32)
    if grid == "pow2":
        q = pow2_floor(q, num_steps)
    elif grid != "dense":
        raise ValueError(grid)
    return q.to(torch.uint8)


def radix_matmul_epilogue_ref(x_q, w_q, bias, mult, num_steps: int, *,
                              periods: int = 1, grid: str = "dense"):
    """Bit-serial matmul + fused output logic -> packed uint8 levels."""
    acc = radix_matmul_ref(x_q, w_q, num_steps, periods=periods)
    return requantize_ref(acc + bias.to(torch.int32), num_steps, mult,
                          grid=grid)


def radix_conv2d_epilogue_ref(x_q, w_q, bias, mult, num_steps: int, *,
                              stride: int = 1, periods: int = 1,
                              grid: str = "dense"):
    """Bit-serial strided VALID conv + fused output logic -> uint8 levels."""
    acc = radix_conv2d_ref(x_q, w_q, num_steps, stride=stride,
                           periods=periods)
    return requantize_ref(acc + bias.to(torch.int32), num_steps, mult,
                          grid=grid)
