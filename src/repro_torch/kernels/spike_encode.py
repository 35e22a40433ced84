"""Radix spike encoder: the CUDA kernel wrapper and its plain version.

Port of ``repro/kernels/spike_encode.py:spike_encode_pallas``: float32 ->
packed radix levels, ``clip(floor(x * c), 0, 2^T - 1)`` with
``c = float32(2^T / scale)``.  The kernel is hand-written CUDA C++ for
sm_90a (``csrc/spike_encode.cu``); :func:`spike_encode_plain` computes the
same function in plain PyTorch.

:func:`spike_encode_cuda` dispatches on the device of its input: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel on the
current stream (and counts the launch in ``spike_encode_cuda.launches``)
or raises.  The kernel is elementwise, so it takes any shape; unlike the
Pallas kernel it needs no row padding.

What bounds it on the card is in the source note of the ``.cu`` file.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, work

__all__ = ["encode_constant", "spike_encode_plain", "spike_encode_cuda"]

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def encode_constant(num_steps: int, scale: float) -> float:
    """``(2^T) / scale`` in double, then rounded to float32 — the weak-typed
    constant the reference kernel multiplies by."""
    return float(torch.tensor((1 << num_steps) / float(scale),
                              dtype=torch.float32))


def _work(x, **_) -> work.Work:
    return work.encode(x.numel())


@work.notes(_work)
def spike_encode_plain(x: torch.Tensor, *, num_steps: int,
                       scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    c = torch.tensor(encode_constant(num_steps, scale), dtype=torch.float32,
                     device=x.device)
    q = torch.floor(x.to(torch.float32) * c)
    return torch.clamp(q, 0, (1 << num_steps) - 1).to(torch.uint8)


@work.notes(_work)
def spike_encode_cuda(x: torch.Tensor, *, num_steps: int,
                      scale: float = 1.0) -> torch.Tensor:
    """float32 (any shape) -> uint8 levels of the same shape.

    CPU tensors run :func:`spike_encode_plain`; CUDA tensors launch the
    kernel or raise."""
    if x.device.type == "cpu":
        return spike_encode_plain(x, num_steps=num_steps, scale=scale)
    if x.device.type != "cuda":
        raise ValueError(f"spike_encode runs on CPU or CUDA, got {x.device}")
    _build.check_tensor(x, "x", (torch.float32,), x.device)
    if not 1 <= num_steps <= 8:
        raise ValueError(f"num_steps must be in [1, 8] for uint8 levels, "
                         f"got {num_steps}")
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return out
    fn = _build.function("spike_encode", "spike_encode_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), out.data_ptr(), x.numel(),
                  encode_constant(num_steps, scale), num_steps,
                  torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise _build.launch_error("spike_encode", code)
    spike_encode_cuda.launches += 1
    return out


spike_encode_cuda.launches = 0
