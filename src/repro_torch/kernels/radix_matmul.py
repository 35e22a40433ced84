"""Radix (bit-serial) matmul: the CUDA kernel wrapper and its plain version.

Port of ``repro/kernels/radix_matmul.py:radix_matmul_pallas``.  The kernel
is hand-written CUDA C++ for sm_90a (``csrc/radix_matmul.cu`` on the int8
tensor-core GEMM of ``csrc/radix_common.cuh``); :func:`radix_matmul_plain`
computes the same function in plain PyTorch (the reference's XLA twin,
``ops._xla_matmul``).

Both take the weights in the reference's (K, N) layout or, with
``kmajor=True``, in the (N, K) layout the kernel reads
(``gemm.matmul_kmajor``, made once where a plan takes its weights).
:func:`radix_matmul_cuda` dispatches on the device of its input: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel on the
current stream (and counts the launch in ``radix_matmul_cuda.launches``)
or raises.  Given (K, N) weights on CUDA it makes the K-major copy for
that call and counts it in ``radix_matmul_cuda.transposes``.  There is no
fallback from a failed build or launch.

What bounds it on the card, and what the design does about it, is in the
source note of ``csrc/radix_matmul.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.encoding import pow2_floor
from repro_torch.core.layers import _int_matmul
from repro_torch.kernels import _build, gemm, work

__all__ = ["OCC_LANES", "plane_occupancy", "occ_mask", "gated",
           "radix_matmul_plain", "radix_matmul_cuda"]

OCC_LANES = 128
"""Width of the plane-occupancy row the kernels consume (entry ``s`` gates
the shift-``s`` plane; entries beyond the bit count are ignored)."""

MAX_STEPS = 31
"""Plane bits an int32 level can carry (``csrc/radix_common.cuh``)."""

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = [_VOID, _INT, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
             _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
             _VOID]


def plane_occupancy(x_q: torch.Tensor,
                    num_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bit-plane occupancy of packed levels.

    Returns ``(row, bits)`` on ``x_q``'s device: ``row`` the ``(1,
    OCC_LANES)`` int32 input the kernels read (entry ``[0, s]`` gates the
    shift-``s`` plane), ``bits`` the ``(num_bits,)`` 0/1 int32 vector.
    PyTorch has no bitwise-OR reduction, so each plane is an ``any`` over
    its bit; nothing syncs with the host.  Each call adds one to
    ``plane_occupancy.calls``.
    """
    plane_occupancy.calls += 1
    bits = torch.stack([((x_q >> s) & 1).any() for s in range(num_bits)])
    bits = bits.to(torch.int32)
    row = torch.zeros((1, OCC_LANES), dtype=torch.int32, device=x_q.device)
    row[0, :num_bits] = bits
    return row, bits


plane_occupancy.calls = 0


def occ_mask(occ: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Bit mask of the occupied planes, ``sum_s occ[s] << s`` (int32, on
    ``occ``'s device) — the fused dataflow's masked-pass operand."""
    shifts = torch.arange(num_steps, dtype=torch.int32, device=occ.device)
    return (occ[:num_steps].to(torch.int32) << shifts).sum(dtype=torch.int32)


def gated(occ: Optional[torch.Tensor], shift: int,
          part: torch.Tensor) -> torch.Tensor:
    """One occupancy-gated plane pass: ``part`` where plane ``shift`` is
    occupied, else zeros (``occ=None`` means ungated).  Selected on the
    device, without a host sync."""
    if occ is None:
        return part
    return torch.where(occ[shift] > 0, part, torch.zeros_like(part))


def _project_levels(q: torch.Tensor, *, out_level: int,
                    out_grid: str) -> torch.Tensor:
    """Clamp a requantized float tile onto the schedule's level grid, uint8."""
    lvl = torch.clamp(q, 0, out_level).to(torch.int32)
    if out_grid == "pow2":
        lvl = pow2_floor(lvl, out_level.bit_length())
    elif out_grid != "dense":
        raise ValueError(f"unknown out_grid {out_grid!r}")
    return lvl.to(torch.uint8)


def _bitserial(x: torch.Tensor, product, num_steps: int, periods: int,
               occ: Optional[torch.Tensor]) -> torch.Tensor:
    """The bitserial dataflow over int32 levels ``x``: Horner over the T
    plane passes, or the phase schedule (``periods * T`` passes weighted
    ``2^shift``, then a floor divide by ``periods``)."""
    acc = None
    if periods == 1:
        for t in range(num_steps):
            shift = num_steps - 1 - t
            part = gated(occ, shift, product((x >> shift) & 1))
            acc = part if acc is None else (acc << 1) + part
        return acc
    for t in range(num_steps * periods):
        shift = num_steps - 1 - (t % num_steps)
        part = gated(occ, shift, product((x >> shift) & 1)) << shift
        acc = part if acc is None else acc + part
    return torch.div(acc, periods, rounding_mode="floor")


def _epilogue(acc, bias, mult, *, num_steps, out_steps, out_level, out_grid):
    """The fused output logic: ``floor(f32(acc + bias) * mult)``, clamp,
    level grid, uint8."""
    out_steps = num_steps if out_steps is None else out_steps
    out_level = (1 << out_steps) - 1 if out_level is None else out_level
    n = acc.shape[-1]
    bias = torch.zeros(n, dtype=torch.int32, device=acc.device) \
        if bias is None else bias.reshape(n)
    q = torch.floor((acc + bias).to(torch.float32) * mult.reshape(n))
    return _project_levels(q, out_level=out_level, out_grid=out_grid)


def _work(x_q, w_q, *, kmajor: bool = False, mult=None, occupancy=None,
          **_) -> work.Work:
    k = x_q.shape[-1]
    return work.gemm("radix_matmul", x_q.numel() // max(k, 1), k,
                     w_q.shape[0 if kmajor else -1],
                     x_bytes=x_q.numel() * x_q.element_size(),
                     epilogue=mult is not None,
                     occupancy=occupancy is not None)


@work.notes(_work)
def radix_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor, *,
                       num_steps: int, method: str = "bitserial",
                       bias: Optional[torch.Tensor] = None,
                       mult: Optional[torch.Tensor] = None,
                       out_steps: Optional[int] = None, periods: int = 1,
                       out_level: Optional[int] = None,
                       out_grid: str = "dense",
                       occupancy: Optional[torch.Tensor] = None,
                       kmajor: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments as
    :func:`radix_matmul_cuda`), on any device."""
    occ = occupancy[0] if occupancy is not None else None
    x = x_q.to(torch.int32)
    if kmajor:
        w_q = gemm.matmul_logical(w_q)
    if method == "fused":
        if occ is not None:
            x = x & occ_mask(occ, num_steps)
        acc = _int_matmul(x, w_q)
    elif method == "bitserial":
        acc = _bitserial(x, lambda p: _int_matmul(p, w_q), num_steps,
                         periods, occ)
    else:
        raise ValueError(f"unknown method {method!r}")
    if mult is None:
        return acc
    return _epilogue(acc, bias, mult, num_steps=num_steps,
                     out_steps=out_steps, out_level=out_level,
                     out_grid=out_grid)


def check_schedule(method: str, num_steps: int, periods: int,
                   out_level: int, out_grid: str) -> None:
    """Raise ``ValueError`` for a schedule the CUDA kernels do not take."""
    if method not in ("fused", "bitserial"):
        raise ValueError(f"unknown method {method!r}")
    if not 1 <= num_steps <= MAX_STEPS:
        raise ValueError(f"num_steps must be in [1, {MAX_STEPS}], "
                         f"got {num_steps}")
    if periods < 1:
        raise ValueError(f"periods must be >= 1, got {periods}")
    if not 0 <= out_level <= 255:
        raise ValueError("packed uint8 epilogue requires out_level <= 255")
    if out_grid not in ("dense", "pow2"):
        raise ValueError(f"unknown out_grid {out_grid!r}")


def epilogue_args(bias, mult, n: int, device: torch.device):
    """Check the epilogue rows (``(1, n)`` or ``(n,)``) for a kernel call."""
    if bias is not None:
        _build.check_tensor(bias, "bias", (torch.int32,), device)
        if bias.numel() != n:
            raise ValueError(f"bias has {bias.numel()} entries, expected {n}")
    _build.check_tensor(mult, "mult", (torch.float32,), device)
    if mult.numel() != n:
        raise ValueError(f"mult has {mult.numel()} entries, expected {n}")


def launch_of(config, m: int, n: int, k: int,
              device: torch.device) -> gemm.Launch:
    """The launch of an (M, K) x (K, N) product on ``device``: the tile and
    split-K ``config`` names, ``gemm.plan``'s where it names none."""
    sms = gemm.device_sms(device)
    if config is None:
        return gemm.plan(m, n, k, sms)
    return config.launch(m, n, k, sms)


def occupancy_arg(occupancy, device: torch.device):
    if occupancy is None:
        return None
    _build.check_tensor(occupancy, "occupancy", (torch.int32,), device, 2)
    if tuple(occupancy.shape) != (1, OCC_LANES):
        raise ValueError(f"occupancy must be (1, {OCC_LANES}), got "
                         f"{tuple(occupancy.shape)}")
    return occupancy.data_ptr()


@work.notes(_work)
def radix_matmul_cuda(x_q: torch.Tensor, w_q: torch.Tensor, *,
                      num_steps: int, method: str = "bitserial",
                      bias: Optional[torch.Tensor] = None,
                      mult: Optional[torch.Tensor] = None,
                      out_steps: Optional[int] = None, periods: int = 1,
                      out_level: Optional[int] = None,
                      out_grid: str = "dense",
                      occupancy: Optional[torch.Tensor] = None,
                      kmajor: bool = False, config=None) -> torch.Tensor:
    """(M, K) packed levels (uint8 or int32) @ (K, N) int8 -> (M, N)
    (``kmajor``: the weights given as (N, K)).

    Without ``mult``: raw int32 accumulators.  With ``mult`` (float32,
    ``N`` entries) and optional ``bias`` (int32): the fused epilogue,
    uint8 levels in ``[0, out_level]`` on ``out_grid``; ``out_level``
    defaults to ``2^out_steps - 1`` (``out_steps`` to ``num_steps``).
    ``periods`` replays the bitserial plane schedule with an exact floor
    divide; ``occupancy`` (``(1, OCC_LANES)`` int32, ``ops.plane_occupancy``)
    skips (bitserial) or masks (fused) empty planes.

    CPU tensors run :func:`radix_matmul_plain`; CUDA tensors launch the
    kernel or raise.  ``config`` (an autotuned ``KernelConfig``) names the
    launch's tile and split-K; by default ``gemm.plan`` picks them.
    """
    kw = dict(num_steps=num_steps, method=method, bias=bias, mult=mult,
              out_steps=out_steps, periods=periods, out_level=out_level,
              out_grid=out_grid, occupancy=occupancy)
    if x_q.device.type == "cpu":
        return radix_matmul_plain(x_q, w_q, kmajor=kmajor, **kw)
    if x_q.device.type != "cuda":
        raise ValueError(f"radix_matmul runs on CPU or CUDA, got {x_q.device}")
    dev = x_q.device
    _build.check_tensor(x_q, "x_q", (torch.uint8, torch.int32), dev, 2)
    _build.check_tensor(w_q, "w_q", (torch.int8,), dev, 2)
    if not kmajor:
        w_q = gemm.matmul_kmajor(w_q)
        radix_matmul_cuda.transposes += 1
    m, k = x_q.shape
    n = w_q.shape[0]
    if w_q.shape[1] != k:
        raise ValueError(f"x_q {tuple(x_q.shape)} and (N, K) weights "
                         f"{tuple(w_q.shape)} do not contract")
    out_steps = num_steps if out_steps is None else out_steps
    out_level = (1 << out_steps) - 1 if out_level is None else out_level
    check_schedule(method, num_steps, periods, out_level, out_grid)
    if mult is not None:
        epilogue_args(bias, mult, n, dev)
    occ_ptr = occupancy_arg(occupancy, dev)
    fused = method == "fused"
    launch = launch_of(config, m, n, k, dev)
    out, work = gemm.buffers(m, n, launch, epilogue=mult is not None,
                             div=1 if fused else periods, device=dev)
    if m == 0 or n == 0:
        return out
    fn = _build.function("radix_matmul", "radix_matmul_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(x_q.data_ptr(), int(x_q.dtype == torch.int32), w_q.data_ptr(),
                  out.data_ptr(), None if work is None else work.data_ptr(),
                  None if mult is None or bias is None else bias.data_ptr(),
                  None if mult is None else mult.data_ptr(), occ_ptr,
                  m, k, n, num_steps, int(fused), periods,
                  out_level, int(out_grid == "pow2"), launch.index,
                  launch.k_chunk, torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise _build.launch_error("radix_matmul", code)
    radix_matmul_cuda.launches += 1
    return out


radix_matmul_cuda.launches = 0
radix_matmul_cuda.transposes = 0
