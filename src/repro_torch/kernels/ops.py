"""Public wrappers around the radix kernels (port of ``repro/kernels/ops.py``,
main-path half).

Handles what the raw kernels omit: SAME pre-padding, strides, bias, the
``(1, N)`` epilogue rows and the plane-occupancy prepass
(``sparsity=True``): one pass finds the bit planes no activation spikes
on, and the kernels skip (bitserial) or mask (fused) them, bit-exactly.

The CUDA kernels mask their own ragged edges, so unlike the reference
nothing is padded to block multiples.  The reference's XLA twins
``_xla_matmul``/``_xla_conv2d`` are the kernels' plain versions,
``radix_matmul.radix_matmul_plain``/``radix_conv.radix_conv2d_plain``.
Autotuning and the decode-attention and spike-encode wrappers come with
later slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.encoding import EncodingSpec, KernelSchedule
from repro_torch.core.layers import same_pads
from repro_torch.kernels.radix_conv import radix_conv2d_cuda
from repro_torch.kernels.radix_matmul import OCC_LANES, radix_matmul_cuda

__all__ = [
    "radix_matmul",
    "radix_conv2d",
    "epilogue_rows",
    "plane_occupancy",
    "same_pads",
]

_AUTOTUNE_LATER = ("autotune=True is not ported yet: the Hopper tuner comes "
                   "with ROADMAP.md queue 1 item 10")


def _schedule(num_steps: Union[int, EncodingSpec]) -> KernelSchedule:
    """A bare T (plain radix schedule) or a kernels-capable spec's
    :class:`KernelSchedule`."""
    if isinstance(num_steps, EncodingSpec):
        num_steps.validate_dataflow(None)
        return num_steps.kernel_schedule()
    return KernelSchedule(packed_bits=int(num_steps))


def plane_occupancy(x_q: torch.Tensor,
                    num_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bit-plane occupancy of packed levels.

    Returns ``(row, bits)`` on ``x_q``'s device: ``row`` the ``(1,
    OCC_LANES)`` int32 input the kernels read (entry ``[0, s]`` gates the
    shift-``s`` plane), ``bits`` the ``(num_bits,)`` 0/1 int32 vector.
    PyTorch has no bitwise-OR reduction, so each plane is an ``any`` over
    its bit; nothing syncs with the host.
    """
    bits = torch.stack([((x_q >> s) & 1).any() for s in range(num_bits)])
    bits = bits.to(torch.int32)
    row = torch.zeros((1, OCC_LANES), dtype=torch.int32, device=x_q.device)
    row[0, :num_bits] = bits
    return row, bits


def epilogue_rows(b_int: Optional[torch.Tensor], mult, n: int, n_pad: int,
                  *, encoding: Optional[EncodingSpec] = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold (bias, requant multiplier) into ``(1, n_pad)`` epilogue rows;
    padding lanes get ``mult = 0`` (level 0)."""
    if encoding is not None:
        _schedule(encoding)
    if device is None:
        device = mult.device if torch.is_tensor(mult) else "cpu"
    bias = torch.zeros(n, dtype=torch.int32, device=device) if b_int is None \
        else b_int.to(device=device, dtype=torch.int32).reshape(n)
    mrow = torch.as_tensor(mult, dtype=torch.float32, device=device)
    mrow = torch.broadcast_to(mrow.reshape(-1), (n,))
    bias = F.pad(bias, (0, n_pad - n)).reshape(1, n_pad)
    mrow = F.pad(mrow, (0, n_pad - n)).reshape(1, n_pad)
    return bias.contiguous(), mrow.contiguous()


def radix_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                 b_int: Optional[torch.Tensor],
                 num_steps: Union[int, EncodingSpec], *,
                 method: str = "bitserial", mult=None,
                 sparsity: bool = False,
                 autotune: bool = False) -> torch.Tensor:
    """(..., K) packed levels @ (K, N) int8 (+bias) -> (..., N).

    ``mult=None``: raw int32 accumulator (+bias outside the kernel);
    ``mult`` given: the fused epilogue, packed uint8 levels.  ``num_steps``
    may be a bare T or a kernels-capable spec.  ``sparsity=True`` runs
    the plane-occupancy prepass."""
    if autotune:
        raise NotImplementedError(_AUTOTUNE_LATER)
    sched = _schedule(num_steps)
    spec = num_steps if isinstance(num_steps, EncodingSpec) else None
    lead = tuple(x_q.shape[:-1])
    k = x_q.shape[-1]
    n = w_q.shape[-1]
    x2 = x_q.reshape(-1, k).contiguous()
    occ = plane_occupancy(x2, sched.packed_bits)[0] if sparsity else None
    kw = dict(num_steps=sched.packed_bits, method=method,
              periods=sched.periods, occupancy=occ)
    if mult is None:
        out = radix_matmul_cuda(x2, w_q, **kw)
        if b_int is not None:
            out = out + b_int.to(out.device)
    else:
        bias_row, mult_row = epilogue_rows(b_int, mult, n, n, encoding=spec,
                                           device=x_q.device)
        out = radix_matmul_cuda(x2, w_q, bias=bias_row, mult=mult_row,
                                out_level=sched.out_level,
                                out_grid=sched.out_grid, **kw)
    return out.reshape(*lead, n)


def radix_conv2d(x_q: torch.Tensor, w_q: torch.Tensor,
                 b_int: Optional[torch.Tensor],
                 num_steps: Union[int, EncodingSpec], *, stride: int = 1,
                 padding: str = "VALID", method: str = "bitserial",
                 mult=None, sparsity: bool = False,
                 autotune: bool = False) -> torch.Tensor:
    """NHWC packed levels * HWIO int8 -> NHWC conv (+bias).

    SAME is pre-padded here (XLA-exact pads for any stride); the stride
    subsamples in-kernel.  ``mult``, ``sparsity`` and ``num_steps`` as in
    :func:`radix_matmul`."""
    if autotune:
        raise NotImplementedError(_AUTOTUNE_LATER)
    sched = _schedule(num_steps)
    spec = num_steps if isinstance(num_steps, EncodingSpec) else None
    kh, kw_, _, cout = w_q.shape
    if padding == "SAME":
        ph = same_pads(x_q.shape[1], kh, stride)
        pw = same_pads(x_q.shape[2], kw_, stride)
        x_q = F.pad(x_q, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(padding)
    x_q = x_q.contiguous()
    occ = plane_occupancy(x_q, sched.packed_bits)[0] if sparsity else None
    kw = dict(num_steps=sched.packed_bits, method=method, stride=stride,
              periods=sched.periods, occupancy=occ)
    if mult is None:
        out = radix_conv2d_cuda(x_q, w_q, **kw)
        return out if b_int is None else out + b_int.to(out.device)
    bias_row, mult_row = epilogue_rows(b_int, mult, cout, cout,
                                       encoding=spec, device=x_q.device)
    return radix_conv2d_cuda(x_q, w_q, bias=bias_row, mult=mult_row,
                             out_level=sched.out_level,
                             out_grid=sched.out_grid, **kw)
