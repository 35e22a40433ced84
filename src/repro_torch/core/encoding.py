"""Radix neural encoding as a first-class spec (port of ``repro/core/encoding.py``).

A radix spike train of length ``T`` decodes to ``q = sum_t 2^(T-1-t) s_t``:
the train *is* the T-bit binary expansion of an integer level in
``[0, 2^T - 1]``, MSB first.  This module holds the encode/decode pairs,
bit-plane packing, the :class:`KernelSchedule` the kernels execute, and
the :class:`EncodingSpec` base with :class:`RadixEncoding`.  Rate, TTFS
and phase specs are not ported yet.

Conventions match the reference: planes are time-major int8 in {0, 1}
(``planes[t]`` is step t, t = 0 the MSB); packed levels are uint8 for
``T <= 8`` and int32 above; real activations map to levels by
``clip(floor(x / scale * 2^T), 0, 2^T - 1)``.

Float op order: ``x / scale`` divides by a float32 tensor on ``x``'s
device.  On CUDA, division by a host scalar is lowered to a multiply by
its reciprocal, which moves levels at their boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "max_level",
    "quantize",
    "dequantize",
    "encode",
    "decode",
    "pack_planes",
    "unpack_planes",
    "pow2_floor",
    "KernelSchedule",
    "KERNEL_OUT_GRIDS",
    "EncodingSpec",
    "RadixEncoding",
]


def max_level(num_steps: int) -> int:
    """Largest integer representable by a radix spike train of length T."""
    return (1 << num_steps) - 1


def _packed_dtype(num_steps: int) -> torch.dtype:
    return torch.uint8 if num_steps <= 8 else torch.int32


def _np_radix_weights(num_steps: int) -> np.ndarray:
    return 1 << np.arange(num_steps - 1, -1, -1)


def _scale_like(x: torch.Tensor, scale) -> torch.Tensor:
    """``scale`` as a float32 tensor on ``x``'s device (see module note)."""
    return torch.as_tensor(scale, dtype=torch.float32, device=x.device)


def quantize(x: torch.Tensor, num_steps: int, scale=1.0) -> torch.Tensor:
    """Real activation -> integer level in [0, 2^T - 1] (ReLU + requantize).

    ``scale`` is the real value mapped to full scale (scalar or
    broadcastable per-channel).  Floor rounding, as the hardware truncates.
    """
    lvl = max_level(num_steps)
    q = torch.floor(x / _scale_like(x, scale) * float(lvl + 1))
    return torch.clamp(q, 0, lvl).to(_packed_dtype(num_steps))


def dequantize(q: torch.Tensor, num_steps: int, scale=1.0) -> torch.Tensor:
    """Integer level -> real activation (``q * scale / 2^T``)."""
    lvl = max_level(num_steps)
    return q.to(torch.float32) * (_scale_like(q, scale) / float(lvl + 1))


def encode(q: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Integer levels -> radix spike train ``(T,) + q.shape``, int8, MSB first."""
    q = q.to(torch.int32)
    shifts = torch.arange(num_steps - 1, -1, -1, dtype=torch.int32,
                          device=q.device)
    shifts = shifts.reshape((num_steps,) + (1,) * q.ndim)
    return ((q.unsqueeze(0) >> shifts) & 1).to(torch.int8)


def decode(planes: torch.Tensor) -> torch.Tensor:
    """Radix spike train ``(T, ...)`` -> int32 levels, by Horner:
    ``acc = (acc << 1) + s_t``."""
    acc = torch.zeros(planes.shape[1:], dtype=torch.int32,
                      device=planes.device)
    for plane in planes.to(torch.int32):
        acc = (acc << 1) + plane
    return acc


def pack_planes(planes: torch.Tensor) -> torch.Tensor:
    """Pack a (T, ...) spike train along time into the integer activation."""
    return decode(planes).to(_packed_dtype(planes.shape[0]))


def unpack_planes(q: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Inverse of :func:`pack_planes` (== :func:`encode`)."""
    return encode(q, num_steps)


def pow2_floor(q: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Largest power of two ``<= q`` (0 for 0), int32 — the TTFS level grid.

    ``q`` holds non-negative levels below ``2^num_steps``.
    """
    q = q.to(torch.int32)
    out = torch.zeros_like(q)
    for s in range(num_steps):
        out = torch.where(q >= (1 << s), torch.full_like(q, 1 << s), out)
    return out


KERNEL_OUT_GRIDS: Tuple[str, ...] = ("dense", "pow2")
"""Level grids the kernel epilogue can project requantized outputs onto."""


@dataclasses.dataclass(frozen=True)
class KernelSchedule:
    """How an encoding's plane-weight algebra maps onto the radix kernels.

    ``packed_bits`` is the bit-serial extraction width, ``periods`` the
    plane-schedule replay count of the bitserial dataflow (the kernels
    floor-divide the accumulator back down), ``out_level`` the epilogue's
    clip ceiling (default ``2^packed_bits - 1``) and ``out_grid`` its
    level grid: ``"dense"`` clips, ``"pow2"`` also floors onto
    ``{0} | {2^k}``.
    """

    packed_bits: int
    periods: int = 1
    out_level: Optional[int] = None
    out_grid: str = "dense"

    def __post_init__(self):
        if self.out_level is None:
            object.__setattr__(self, "out_level",
                               (1 << self.packed_bits) - 1)


@dataclasses.dataclass(frozen=True)
class EncodingSpec:
    """A neural encoding as a first-class object.

    A spec owns the numeric semantics (``quantize``/``dequantize``,
    ``encode``/``decode``, ``reduce_planes``, ``requantize``) and declares
    what runs it (``backends``, ``kernel_dataflows``, ``pool_modes``).
    Specs are frozen so they serve as plan-cache key components.
    """

    num_steps: int

    name: ClassVar[str] = "abstract"
    backends: ClassVar[Tuple[str, ...]] = ()
    kernel_dataflows: ClassVar[Tuple[str, ...]] = ()
    pool_modes: ClassVar[Tuple[str, ...]] = ()
    periods: ClassVar[int] = 1

    def __post_init__(self):
        if self.num_steps < 1:
            raise ValueError(
                f"num_steps must be >= 1, got {self.num_steps}")

    @property
    def levels(self) -> int:
        """Distinct integer levels a train of ``num_steps`` represents."""
        raise NotImplementedError

    @property
    def max_level(self) -> int:
        return self.levels - 1

    @property
    def packed_bits(self) -> int:
        """Bits of the packed integer form consumed by the kernels."""
        return self.num_steps

    @property
    def packed_dtype(self) -> torch.dtype:
        """dtype of packed levels (uint8 while ``max_level`` fits a byte)."""
        return torch.uint8 if self.max_level <= 255 else torch.int32

    @property
    def radix_planes(self) -> bool:
        """True when ``encode`` emits the MSB-first binary expansion of the
        packed level (what the bit-plane max-pool relies on)."""
        return False

    def plane_weights(self) -> np.ndarray:
        """Per-time-step decode weights ``w_t``, shape ``(num_steps,)``."""
        raise NotImplementedError

    @property
    def scale_factor(self) -> float:
        """Full-scale headroom folded into calibrated scales by ``convert``."""
        return 1.0

    def quantize(self, x: torch.Tensor, scale=1.0) -> torch.Tensor:
        """``clip(floor(x / scale * levels), 0, max_level)`` in ``packed_dtype``."""
        q = torch.floor(x / _scale_like(x, scale) * float(self.levels))
        return torch.clamp(q, 0, self.max_level).to(self.packed_dtype)

    def dequantize(self, q: torch.Tensor, scale=1.0) -> torch.Tensor:
        return q.to(torch.float32) * (_scale_like(q, scale)
                                      / float(self.levels))

    def encode(self, q: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, planes: torch.Tensor) -> torch.Tensor:
        return self.reduce_planes(planes)

    def reduce_planes(self, per_step: torch.Tensor) -> torch.Tensor:
        """``sum_t w_t * per_step[t] // periods`` as one int32 membrane."""
        w = torch.as_tensor(self.plane_weights(), dtype=torch.int32,
                            device=per_step.device)
        w = w.reshape((self.num_steps,) + (1,) * (per_step.ndim - 1))
        acc = (per_step.to(torch.int32) * w).sum(0, dtype=torch.int32)
        if self.periods > 1:
            acc = torch.div(acc, self.periods, rounding_mode="floor")
        return acc

    def requantize(self, acc: torch.Tensor, mult) -> torch.Tensor:
        """``clip(floor(f32(acc) * mult), 0, max_level)`` in ``packed_dtype``
        — the contract of the kernels' fused epilogue."""
        q = torch.floor(acc.to(torch.float32) * _scale_like(acc, mult))
        return torch.clamp(q, 0, self.max_level).to(self.packed_dtype)

    def supports_pool(self, pool_mode: str) -> bool:
        return pool_mode in self.pool_modes

    def validate_static(self, static) -> None:
        """Raise ``ValueError`` when a pool layer of ``static`` uses a mode
        this encoding does not preserve."""
        for kind, cfg in static:
            if kind == "pool" and not self.supports_pool(
                    cfg.get("mode", "or")):
                raise ValueError(
                    f"{self.name} encoding does not preserve pool mode "
                    f"{cfg.get('mode', 'or')!r} (supported: "
                    f"{self.pool_modes})")

    def kernel_schedule(self) -> KernelSchedule:
        """This encoding's :class:`KernelSchedule`; raises ``ValueError``
        when the encoding declares no kernel dataflow."""
        if not self.kernel_dataflows:
            raise ValueError(
                f"{self.name} encoding has no kernel dataflow; supported "
                f"backends: {self.backends}")
        return KernelSchedule(packed_bits=self.packed_bits,
                              periods=self.periods,
                              out_level=self.max_level)

    def validate_dataflow(self, dataflow: Optional[str]) -> str:
        """Resolve ``dataflow`` (None -> ``kernel_dataflows[0]``) after
        checking that the schedule can carry the spec's own levels."""
        sched = self.kernel_schedule()
        if sched.out_grid not in KERNEL_OUT_GRIDS:
            raise ValueError(
                f"{self.name} encoding declares kernel out_grid "
                f"{sched.out_grid!r}; supported: {KERNEL_OUT_GRIDS}")
        if (sched.out_level != self.max_level
                or sched.out_level > (1 << sched.packed_bits) - 1
                or sched.out_level > 255):
            raise ValueError(
                f"{self.name} encoding declares kernel dataflows but its "
                f"schedule is inconsistent: out_level={sched.out_level} "
                f"must equal max_level={self.max_level}, fit "
                f"packed_bits={sched.packed_bits} bits and fit the packed "
                f"uint8 buffers (<= 255)")
        if dataflow is None:
            return self.kernel_dataflows[0]
        if dataflow not in self.kernel_dataflows:
            raise ValueError(
                f"dataflow must be one of {self.kernel_dataflows} for "
                f"{self.name} encoding, got {dataflow!r}")
        return dataflow


@dataclasses.dataclass(frozen=True)
class RadixEncoding(EncodingSpec):
    """The paper's radix encoding: ``planes[t]`` weighs ``2^(T-1-t)``."""

    name: ClassVar[str] = "radix"
    backends: ClassVar[Tuple[str, ...]] = ("kernels",)
    kernel_dataflows: ClassVar[Tuple[str, ...]] = ("fused", "bitserial")
    pool_modes: ClassVar[Tuple[str, ...]] = ("or", "avg", "max")

    @property
    def levels(self) -> int:
        return 1 << self.num_steps

    @property
    def radix_planes(self) -> bool:
        return True

    def plane_weights(self) -> np.ndarray:
        return _np_radix_weights(self.num_steps)

    def quantize(self, x, scale=1.0):
        return quantize(x, self.num_steps, scale)

    def dequantize(self, q, scale=1.0):
        return dequantize(q, self.num_steps, scale)

    def encode(self, q):
        return encode(q, self.num_steps)

    def decode(self, planes):
        return decode(planes)

    def reduce_planes(self, per_step):
        """Horner accumulation ``(acc << 1) + I_t`` over the time axis."""
        return decode(per_step)
