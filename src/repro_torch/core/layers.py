"""Spiking / quantized layer twins (port of ``repro/core/layers.py``).

Every layer exists as a twin pair on the same integer arithmetic:
``q_*`` on packed levels, ``snn_*`` on radix spike trains ``(T, ...)``
Horner-accumulated over time; the pair is bit-exact by linearity.

Layout follows the reference: NHWC activations, HWIO conv weights, time
first for spike trains.  PyTorch has no integer convolution or GEMM on
CUDA, so ``_int_conv``/``_int_matmul`` compute in float64 — exact while
every partial sum stays below 2^53 — and cast back to int32.  Pools
reduce integer tensors by reshape over the VALID crop (``F.avg_pool2d``
and ``F.max_pool2d`` take no integer tensors).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import neuron

__all__ = [
    "q_conv2d",
    "snn_conv2d",
    "q_linear",
    "snn_linear",
    "q_avg_pool",
    "snn_avg_pool",
    "q_max_pool",
    "snn_max_pool",
    "q_or_pool",
    "snn_or_pool",
    "q_requantize",
    "sum_pool_bits",
]


def same_pads(size: int, k: int, stride: int):
    """(lo, hi) explicit pads matching XLA "SAME" for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _int_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
              padding: str) -> torch.Tensor:
    """Integer conv, NHWC x HWIO -> NHWC int32 (float64 products, exact)."""
    if padding == "SAME":
        ph = same_pads(x.shape[-3], w.shape[0], stride)
        pw = same_pads(x.shape[-2], w.shape[1], stride)
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(padding)
    xf = x.to(torch.float64).permute(0, 3, 1, 2)
    wf = w.to(device=x.device, dtype=torch.float64).permute(3, 2, 0, 1)
    out = F.conv2d(xf, wf, stride=stride)
    return out.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def _int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Integer ``x @ w`` over the last axis -> int32 (float64, exact)."""
    w = w.to(device=x.device, dtype=torch.float64)
    return torch.matmul(x.to(torch.float64), w).to(torch.int32)


def _per_plane(fn, planes: torch.Tensor) -> torch.Tensor:
    """Apply an NHWC op to every plane of a ``(T, N, H, W, C)`` train."""
    out = fn(planes.reshape((-1,) + tuple(planes.shape[2:])))
    return out.reshape(tuple(planes.shape[:2]) + tuple(out.shape[1:]))


def q_requantize(acc: torch.Tensor, num_steps: int, mult) -> torch.Tensor:
    """Shared ReLU + requantize stage (== ``neuron.radix_fire``) — the
    contract of the kernels' fused epilogue."""
    return neuron.radix_fire(acc, num_steps, mult)


def sum_pool_bits(bits: int, window: int) -> int:
    """Integer bits carried by a sum-pool output whose inputs use ``bits``."""
    return max(1, int(((1 << bits) - 1) * window * window).bit_length())


def q_conv2d(q_in, w_q, b_int, *, stride: int = 1, padding: str = "VALID"):
    """Integer conv accumulator: (N,H,W,Cin) levels -> (N,H',W',Cout) int32."""
    return _int_conv(q_in, w_q, stride, padding) + b_int.to(q_in.device)


def snn_conv2d(planes, w_q, b_int, *, stride: int = 1, padding: str = "VALID"):
    """Radix spike-train conv: Horner over T binary-plane convs (paper Alg. 1)."""
    per_step = _per_plane(lambda p: _int_conv(p, w_q, stride, padding), planes)
    return neuron.radix_membrane(per_step) + b_int.to(planes.device)


def q_linear(q_in, w_q, b_int):
    """Integer matmul accumulator: (N,F) levels @ (F,G) int8 -> (N,G) int32."""
    return _int_matmul(q_in, w_q) + b_int.to(q_in.device)


def snn_linear(planes, w_q, b_int):
    """Radix spike-train linear layer (Horner over per-plane matmuls)."""
    return neuron.radix_membrane(_int_matmul(planes, w_q)) \
        + b_int.to(planes.device)


def _windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """(N,H,W,C) -> (N,H',window,W',window,C) over the VALID crop."""
    n, h, w, c = x.shape
    ho, wo = h // window, w // window
    x = x[:, :ho * window, :wo * window, :]
    return x.reshape(n, ho, window, wo, window, c)


def q_avg_pool(q_in: torch.Tensor, window: int) -> torch.Tensor:
    """Sum-pool accumulator (int32); the window division folds into the
    next layer's multiplier."""
    return _windows(q_in.to(torch.int32), window).sum(dim=(2, 4),
                                                      dtype=torch.int32)


def snn_avg_pool(planes: torch.Tensor, window: int) -> torch.Tensor:
    """Spiking sum-pool: per-plane window sums, Horner over time."""
    return neuron.radix_membrane(
        _per_plane(lambda p: q_avg_pool(p, window), planes))


def q_max_pool(q_in: torch.Tensor, window: int) -> torch.Tensor:
    return _windows(q_in, window).amax(dim=(2, 4))


def q_or_pool(q_in: torch.Tensor, window: int) -> torch.Tensor:
    """Bitwise-OR pooling of packed radix levels (per-plane OR over the
    window, the paper's pooling unit)."""
    n, h, w, c = q_in.shape
    hc, wc = h // window * window, w // window * window
    out = None
    for i in range(window):
        for j in range(window):
            tap = q_in[:, i:hc:window, j:wc:window, :]
            out = tap if out is None else out | tap
    return out


def snn_or_pool(planes: torch.Tensor, window: int) -> torch.Tensor:
    """Per-plane OR (binary max) pooling; returns pooled spike planes."""
    return _per_plane(lambda p: q_max_pool(p, window), planes)


def snn_max_pool(planes: torch.Tensor, window: int) -> torch.Tensor:
    """Max-pool in the bit-plane domain: a lexicographic MSB->LSB walk with
    a per-element "still in contention" mask.  Returns packed levels in
    ``planes.dtype`` (the reference's contract)."""
    num_steps = planes.shape[0]
    hc = planes.shape[2] // window * window
    wc = planes.shape[3] // window * window
    planes = planes[:, :, :hc, :wc, :]
    contention = torch.ones(planes.shape[1:], dtype=torch.int8,
                            device=planes.device)
    out_bits = []
    for t in range(num_steps):
        gated = planes[t] * contention
        out_bit = q_max_pool(gated, window)
        up = out_bit.repeat_interleave(window, dim=1).repeat_interleave(
            window, dim=2)
        contention = contention * (gated == up).to(torch.int8)
        out_bits.append(out_bit)
    return neuron.radix_membrane(torch.stack(out_bits)).to(planes.dtype)
