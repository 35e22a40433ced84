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

Besides raw int32 sums and the CNN's uint8 output logic (``mult``), the
kernel dequantizes for the LM (``dequant``, a :class:`Dequant`): it stores
the bf16 or float32 values that ``lm/radix.py``'s float32 glue would make
of the sums, bit for bit (:func:`dequantize` is that glue).  The same
library holds the LM's one-pass activation quantize
(:func:`radix_quantize_cuda`, plain version :func:`radix_quantize_plain`):
an activation row, or the SwiGLU / GeGLU product of a gate and an up row,
to uint8 radix levels and a float32 scale, with no float intermediate
written.

What bounds it on the card, and what the design does about it, is in the
source note of ``csrc/radix_matmul.cu``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.encoding import pow2_floor
from repro_torch.core.layers import _int_matmul
from repro_torch.kernels import _build, gemm, work

__all__ = ["OCC_LANES", "plane_occupancy", "occ_mask", "gated",
           "Dequant", "dequantize", "radix_matmul_plain", "radix_matmul_cuda",
           "GLU_ACTS", "glu", "quantize_rows", "quantize_fits",
           "radix_quantize_plain", "radix_quantize_cuda"]

OCC_LANES = 128
"""Width of the plane-occupancy row the kernels consume (entry ``s`` gates
the shift-``s`` plane; entries beyond the bit count are ignored)."""

MAX_STEPS = 31
"""Plane bits an int32 level can carry (``csrc/radix_common.cuh``)."""

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = [_VOID, _INT, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,
             _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
             _INT, _VOID, ctypes.c_float, _VOID]
_QUANT_ARGTYPES = [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT,
                   _INT, _VOID]
_FLOATS = {torch.bfloat16: 1, torch.float32: 2}
"""The float dtypes the library takes: the dequantize epilogue's outputs
(the value is its ``out_kind`` argument) and the quantize's inputs."""

GLU_ACTS = {"swiglu": 1, "geglu": 2}
"""The gated activations the one-pass quantize fuses (its ``act`` argument)."""

QUANT_SMEM = 200 * 1024
"""The longest row, in bytes, the one-pass quantize holds in shared
memory (``csrc/radix_matmul.cu``)."""


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


@dataclasses.dataclass(frozen=True)
class Dequant:
    """The LM's dequantize epilogue: ``y[m, n] = ((coef * f32(acc) -
    f32(colsum[n])) * sx[m]) * sw[n]``, each step rounded to float32, then
    rounded to ``dtype``."""

    sx: torch.Tensor      # M float32 row scales (any shape, e.g. (..., 1))
    sw: torch.Tensor      # (N,) float32 column scales
    colsum: torch.Tensor  # (N,) int32 column sums of the weights
    coef: float           # 2 / lvl, taken as a float32
    dtype: torch.dtype    # bfloat16 or float32


def dequantize(acc: torch.Tensor, d: Dequant) -> torch.Tensor:
    """The dequantize epilogue in plain PyTorch on (..., N) int32 sums
    (``d.sx`` one scale a row of them): the float32 glue of
    ``lm/radix.maybe_radix_matmul``'s int32 path, which runs it."""
    y = d.coef * acc.to(torch.float32) - d.colsum.to(torch.float32)
    y = y * d.sx.reshape(acc.shape[:-1] + (1,)) * d.sw
    return y.to(d.dtype)


def _work(x_q, w_q, *, kmajor: bool = False, mult=None, occupancy=None,
          dequant: Optional[Dequant] = None, **_) -> work.Work:
    k = x_q.shape[-1]
    return work.gemm("radix_matmul", x_q.numel() // max(k, 1), k,
                     w_q.shape[0 if kmajor else -1],
                     x_bytes=x_q.numel() * x_q.element_size(),
                     epilogue=mult is not None,
                     occupancy=occupancy is not None,
                     out_bytes=None if dequant is None
                     else dequant.dtype.itemsize)


@work.notes(_work)
def radix_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor, *,
                       num_steps: int, method: str = "bitserial",
                       bias: Optional[torch.Tensor] = None,
                       mult: Optional[torch.Tensor] = None,
                       out_steps: Optional[int] = None, periods: int = 1,
                       out_level: Optional[int] = None,
                       out_grid: str = "dense",
                       occupancy: Optional[torch.Tensor] = None,
                       kmajor: bool = False,
                       dequant: Optional[Dequant] = None) -> torch.Tensor:
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
    if dequant is not None:
        return dequantize(acc, dequant)
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


def dequant_args(d: Dequant, m: int, n: int, device: torch.device) -> None:
    """Check a :class:`Dequant` for a kernel call."""
    if d.dtype not in _FLOATS:
        raise ValueError(f"dequant dtype must be one of "
                         f"{tuple(_FLOATS)}, got {d.dtype}")
    for name, t, dt, size in (("sx", d.sx, torch.float32, m),
                              ("sw", d.sw, torch.float32, n),
                              ("colsum", d.colsum, torch.int32, n)):
        _build.check_tensor(t, name, (dt,), device)
        if t.numel() != size:
            raise ValueError(f"{name} has {t.numel()} entries, expected "
                             f"{size}")


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
                      kmajor: bool = False, config=None,
                      dequant: Optional[Dequant] = None) -> torch.Tensor:
    """(M, K) packed levels (uint8 or int32) @ (K, N) int8 -> (M, N)
    (``kmajor``: the weights given as (N, K)).

    Without ``mult`` or ``dequant``: raw int32 accumulators.  With
    ``mult`` (float32, ``N`` entries) and optional ``bias`` (int32): the
    fused epilogue, uint8 levels in ``[0, out_level]`` on ``out_grid``;
    ``out_level`` defaults to ``2^out_steps - 1`` (``out_steps`` to
    ``num_steps``).  With ``dequant`` (uint8 levels only): the
    :class:`Dequant` epilogue's ``dequant.dtype`` values, equal to
    :func:`dequantize` of the int32 sums.
    ``periods`` replays the bitserial plane schedule with an exact floor
    divide; ``occupancy`` (``(1, OCC_LANES)`` int32, ``ops.plane_occupancy``)
    skips (bitserial) or masks (fused) empty planes.

    CPU tensors run :func:`radix_matmul_plain`; CUDA tensors launch the
    kernel or raise.  ``config`` (an autotuned ``KernelConfig``) names the
    launch's tile and split-K; by default ``gemm.plan`` picks them.
    """
    kw = dict(num_steps=num_steps, method=method, bias=bias, mult=mult,
              out_steps=out_steps, periods=periods, out_level=out_level,
              out_grid=out_grid, occupancy=occupancy, dequant=dequant)
    if mult is not None and dequant is not None:
        raise ValueError("mult and dequant are two epilogues; give one")
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
    if dequant is not None:
        if x_q.dtype != torch.uint8:
            raise ValueError("the dequantize epilogue takes uint8 levels")
        dequant_args(dequant, m, n, dev)
        # the kernel reads the column sums and scales as its column rows
        bias, mult = dequant.colsum, dequant.sw
    occ_ptr = occupancy_arg(occupancy, dev)
    fused = method == "fused"
    launch = launch_of(config, m, n, k, dev)
    out, work = gemm.buffers(
        m, n, launch, epilogue=mult is not None,
        div=1 if fused else periods, device=dev,
        dtype=None if dequant is None else dequant.dtype)
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
                  launch.k_chunk,
                  0 if dequant is None else _FLOATS[dequant.dtype],
                  None if dequant is None else dequant.sx.data_ptr(),
                  0.0 if dequant is None else dequant.coef,
                  torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise _build.launch_error("radix_matmul", code)
    radix_matmul_cuda.launches += 1
    return out


radix_matmul_cuda.launches = 0
radix_matmul_cuda.transposes = 0


# ---------------------------------------------------------------------------
# The one-pass activation quantize.
# ---------------------------------------------------------------------------


def quantize_fits(cols: int, dtype: torch.dtype) -> bool:
    """Whether the one-pass quantize kernel takes rows of ``cols`` values
    of ``dtype`` (bfloat16 or float32, held whole in shared memory)."""
    return (dtype in _FLOATS
            and 0 < cols * dtype.itemsize <= QUANT_SMEM)


def _act_id(act: Optional[str]) -> int:
    """The kernel's ``act`` argument: 0 for none, else ``GLU_ACTS``'s."""
    if act is not None and act not in GLU_ACTS:
        raise ValueError(f"act must be one of {tuple(GLU_ACTS)}, got {act!r}")
    return GLU_ACTS.get(act, 0)


def glu(g: torch.Tensor, up: torch.Tensor, act: str) -> torch.Tensor:
    """A gated activation (``GLU_ACTS``) of the gate ``g`` times ``up``, as
    tensor code: the product the GLU quantize kernel forms in registers."""
    _act_id(act)
    a = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
    return a * up


def quantize_rows(x: torch.Tensor, num_steps: int, row_max=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Signed activations -> (uint8 radix levels, (..., 1) float32 row
    scales), as tensor code: the levels ``clamp(round((x / s + 1) * 0.5 *
    lvl), 0, lvl)`` of the affine-shifted value against ``s = f32(a) +
    1e-9``, ``a`` the row's absmax in ``x``'s dtype.  ``row_max`` (e.g. a
    max over 'model', where ``x`` is a slice of each row) takes the
    slices' float32 absmax to the whole row's before the scale is made."""
    lvl = (1 << num_steps) - 1
    a = x.abs().amax(dim=-1, keepdim=True).to(torch.float32)
    if row_max is not None:
        a = row_max(a)
    s = a + 1e-9
    u = (x.to(torch.float32) / s + 1.0) * 0.5
    q = torch.clamp(torch.round(u * lvl), 0, lvl).to(torch.uint8)
    return q, s


def _quantize_work(x, num_steps, *, act=None, **_) -> work.Work:
    k = x.shape[-1]
    return work.quantize(x.numel() // max(k, 1), k,
                         x_bytes=x.numel() * x.element_size(),
                         glu=act is not None)


@work.notes(_quantize_work)
def radix_quantize_plain(x: torch.Tensor, num_steps: int, *,
                         act: Optional[str] = None,
                         up: Optional[torch.Tensor] = None,
                         h: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the one-pass quantize (same arguments as
    :func:`radix_quantize_cuda`), on any device: :func:`quantize_rows` of
    ``x`` (or of :func:`glu` of ``x`` and ``up``)."""
    x = x if act is None else glu(x, up, act)
    if h is not None:
        h.copy_(x)
    return quantize_rows(x, num_steps)


@work.notes(_quantize_work)
def radix_quantize_cuda(x: torch.Tensor, num_steps: int, *,
                        act: Optional[str] = None,
                        up: Optional[torch.Tensor] = None,
                        h: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) activations -> ((..., K) uint8 radix levels, (..., 1)
    float32 scales), one pass over each row: the levels of ``(x / s +
    1) / 2`` against the row's scale ``s`` (``lm/radix.py``'s activation
    quantize).  ``act`` ("swiglu" / "geglu", ``GLU_ACTS``): ``x`` is a
    gate and ``up`` the up product, and the quantized row is ``act(x) *
    up`` as PyTorch rounds it, never written unless ``h`` (a tensor like
    ``x``) asks for it.

    CPU tensors run :func:`radix_quantize_plain`; CUDA tensors (bfloat16
    or float32, rows that :func:`quantize_fits`) launch the kernel, count
    it in ``radix_quantize_cuda.launches``, or raise."""
    if x.device.type == "cpu":
        return radix_quantize_plain(x, num_steps, act=act, up=up, h=h)
    if x.device.type != "cuda":
        raise ValueError(f"radix_quantize runs on CPU or CUDA, got {x.device}")
    dev = x.device
    _build.check_tensor(x, "x", tuple(_FLOATS), dev)
    if act is not None:
        _act_id(act)
        _build.check_tensor(up, "up", (x.dtype,), dev)
        if up.shape != x.shape:
            raise ValueError(f"up {tuple(up.shape)} is not shaped like x "
                             f"{tuple(x.shape)}")
    if h is not None:
        _build.check_tensor(h, "h", (x.dtype,), dev)
        if h.shape != x.shape:
            raise ValueError(f"h {tuple(h.shape)} is not shaped like x "
                             f"{tuple(x.shape)}")
    k = x.shape[-1]
    if not quantize_fits(k, x.dtype):
        raise ValueError(f"rows of {k} {x.dtype} values exceed the "
                         f"{QUANT_SMEM} bytes the kernel holds")
    if not 1 <= num_steps <= 8:
        raise ValueError(f"num_steps must be in [1, 8], got {num_steps}")
    q = torch.empty(x.shape, dtype=torch.uint8, device=dev)
    s = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=dev)
    rows = x.numel() // k
    if rows == 0:
        return q, s
    fn = _build.function("radix_matmul", "radix_quantize_launch",
                         _QUANT_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), None if act is None else up.data_ptr(),
                  None if h is None else h.data_ptr(), q.data_ptr(),
                  s.data_ptr(), int(x.dtype == torch.bfloat16),
                  _act_id(act), rows, k, num_steps,
                  torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise _build.launch_error("radix_quantize", code)
    radix_quantize_cuda.launches += 1
    return q, s


radix_quantize_cuda.launches = 0
