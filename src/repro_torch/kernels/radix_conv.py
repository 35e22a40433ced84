"""Radix (bit-serial) 2-D convolution: the CUDA kernel wrapper and its plain version.

Port of ``repro/kernels/radix_conv.py:radix_conv2d_pallas``.  The kernel
is hand-written CUDA C++ for sm_90a (``csrc/radix_conv.cu``, an implicit
GEMM on the int8 tensor-core mainloop of ``csrc/radix_common.cuh``, shared
with the matmul the way the reference imports ``gated``/``occ_mask``/
``_project_levels`` from ``radix_matmul.py``); :func:`radix_conv2d_plain`
computes the same function in plain PyTorch (the reference's XLA twin,
``ops._xla_conv2d``).

Both take the weights in the reference's HWIO layout or, with
``kmajor=True``, in the (Cout, KH, KW, Cin) layout the kernel reads
(``gemm.conv_kmajor``, made once where a plan takes its weights).
:func:`radix_conv2d_cuda` dispatches on the device of its input: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel on the
current stream (and counts the launch in ``radix_conv2d_cuda.launches``)
or raises.  Given HWIO weights on CUDA it makes the K-major copy for that
call and counts it in ``radix_conv2d_cuda.transposes``.  VALID only: SAME
is pre-padded by the caller (``ops.radix_conv2d``, the compiled plan); the
stride subsamples in-kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.layers import _int_conv
from repro_torch.kernels import _build, gemm
from repro_torch.kernels.radix_matmul import (
    _bitserial,
    _epilogue,
    check_schedule,
    epilogue_args,
    launch_of,
    occ_mask,
    occupancy_arg,
)

__all__ = ["radix_conv2d_plain", "radix_conv2d_cuda"]

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = [_VOID, _INT, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
             _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
             _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VOID]


def radix_conv2d_plain(x_q: torch.Tensor, w_q: torch.Tensor, *,
                       num_steps: int, method: str = "bitserial",
                       stride: int = 1,
                       bias: Optional[torch.Tensor] = None,
                       mult: Optional[torch.Tensor] = None,
                       out_steps: Optional[int] = None, periods: int = 1,
                       out_level: Optional[int] = None,
                       out_grid: str = "dense",
                       occupancy: Optional[torch.Tensor] = None,
                       kmajor: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments as
    :func:`radix_conv2d_cuda`), on any device."""
    occ = occupancy[0] if occupancy is not None else None
    x = x_q.to(torch.int32)
    if kmajor:
        w_q = gemm.conv_logical(w_q)

    def conv(p):
        return _int_conv(p, w_q, stride, "VALID")

    if method == "fused":
        if occ is not None:
            x = x & occ_mask(occ, num_steps)
        acc = conv(x)
    elif method == "bitserial":
        acc = _bitserial(x, conv, num_steps, periods, occ)
    else:
        raise ValueError(f"unknown method {method!r}")
    if mult is None:
        return acc
    return _epilogue(acc, bias, mult, num_steps=num_steps,
                     out_steps=out_steps, out_level=out_level,
                     out_grid=out_grid)


def radix_conv2d_cuda(x_q: torch.Tensor, w_q: torch.Tensor, *,
                      num_steps: int, method: str = "bitserial",
                      stride: int = 1,
                      bias: Optional[torch.Tensor] = None,
                      mult: Optional[torch.Tensor] = None,
                      out_steps: Optional[int] = None, periods: int = 1,
                      out_level: Optional[int] = None,
                      out_grid: str = "dense",
                      occupancy: Optional[torch.Tensor] = None,
                      kmajor: bool = False, config=None) -> torch.Tensor:
    """(N, H, W, Cin) packed levels (uint8 or int32) conv (KH, KW, Cin, Cout)
    int8 -> VALID, strided (N, H', W', Cout) (``kmajor``: the weights given
    as (Cout, KH, KW, Cin)).

    Without ``mult``: int32 accumulators.  With ``mult`` (float32, Cout
    entries) and optional ``bias`` (int32): the fused epilogue, uint8
    levels.  ``periods``, ``out_level``/``out_steps``, ``out_grid`` and
    ``occupancy`` as in ``radix_matmul_cuda``.

    CPU tensors run :func:`radix_conv2d_plain`; CUDA tensors launch the
    kernel or raise.  ``config`` (an autotuned ``KernelConfig``) names the
    launch's tile and split-K; by default ``gemm.plan`` picks them.
    """
    kw = dict(num_steps=num_steps, method=method, stride=stride, bias=bias,
              mult=mult, out_steps=out_steps, periods=periods,
              out_level=out_level, out_grid=out_grid, occupancy=occupancy)
    if x_q.device.type == "cpu":
        return radix_conv2d_plain(x_q, w_q, kmajor=kmajor, **kw)
    if x_q.device.type != "cuda":
        raise ValueError(f"radix_conv2d runs on CPU or CUDA, got {x_q.device}")
    dev = x_q.device
    _build.check_tensor(x_q, "x_q", (torch.uint8, torch.int32), dev, 4)
    _build.check_tensor(w_q, "w_q", (torch.int8,), dev, 4)
    if not kmajor:
        w_q = gemm.conv_kmajor(w_q)
        radix_conv2d_cuda.transposes += 1
    n, h, w, cin = x_q.shape
    cout, kh, kwd, cin2 = w_q.shape
    if cin2 != cin:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} disagree on Cin")
    if stride < 1 or h < kh or w < kwd:
        raise ValueError(f"VALID conv of {(h, w)} by {(kh, kwd)} with "
                         f"stride {stride} has no output")
    h_out = (h - kh) // stride + 1
    w_out = (w - kwd) // stride + 1
    out_steps = num_steps if out_steps is None else out_steps
    out_level = (1 << out_steps) - 1 if out_level is None else out_level
    check_schedule(method, num_steps, periods, out_level, out_grid)
    if mult is not None:
        epilogue_args(bias, mult, cout, dev)
    occ_ptr = occupancy_arg(occupancy, dev)
    fused = method == "fused"
    m, k = n * h_out * w_out, kh * kwd * cin
    launch = launch_of(config, m, cout, k, dev)
    out, work = gemm.buffers(m, cout, launch, epilogue=mult is not None,
                             div=1 if fused else periods, device=dev)
    out = out.reshape(n, h_out, w_out, cout)
    if out.numel() == 0:
        return out
    fn = _build.function("radix_conv", "radix_conv2d_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(x_q.data_ptr(), int(x_q.dtype == torch.int32), w_q.data_ptr(),
                  out.data_ptr(), None if work is None else work.data_ptr(),
                  None if mult is None or bias is None else bias.data_ptr(),
                  None if mult is None else mult.data_ptr(), occ_ptr,
                  n, h, w, cin, kh, kwd, cout, stride, num_steps,
                  int(fused), periods, out_level, int(out_grid == "pow2"),
                  launch.index, launch.k_chunk,
                  torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise _build.launch_error("radix_conv2d", code)
    radix_conv2d_cuda.launches += 1
    return out


radix_conv2d_cuda.launches = 0
radix_conv2d_cuda.transposes = 0
