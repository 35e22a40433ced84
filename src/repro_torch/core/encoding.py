"""Neural encodings as first-class specs (port of ``repro/core/encoding.py``).

Every encoding is a plane-weight scheme: a spike train of length ``T``
decodes to ``q = sum_t w_t s_t`` (divided by the number of repeated
periods, if any):

* **radix** — ``w_t = 2^(T-1-t)``: the train *is* the T-bit binary
  expansion of an integer level in ``[0, 2^T - 1]``, MSB first;
* **rate** — ``w_t = 1``: the spike count is the level (``T + 1`` levels);
* **TTFS** — radix weights with at most one spike per activation, at
  ``t = T - 1 - msb(q)``: the level grid is ``{0} | {2^k}``;
* **phase** — radix weights over ``K = T / P`` phases tiled ``P`` times,
  decode divides by ``P``.

This module holds the encode/decode pairs, bit-plane packing, the
:class:`KernelSchedule` the kernels execute, the :class:`EncodingSpec`
hierarchy and the support matrix generated from the specs' declarations.

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
    "rate_encode",
    "rate_decode",
    "KernelSchedule",
    "KERNEL_OUT_GRIDS",
    "EncodingSpec",
    "RadixEncoding",
    "RateEncoding",
    "TTFSEncoding",
    "PhaseEncoding",
    "SPECS",
    "support_matrix",
    "support_matrix_markdown",
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


def rate_encode(x: torch.Tensor, num_steps: int, scale=1.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Rate coding: spike probability proportional to ``clip(x / scale,
    0, 1)``; returns ``(T,) + x.shape`` int8.

    Without ``generator``: evenly spaced spikes by float32 error
    accumulation (sigma-delta).  With one: Bernoulli spikes drawn from
    it (on the generator's device, which must be ``x``'s).
    """
    p = torch.clamp(x / _scale_like(x, scale), 0.0, 1.0)
    if generator is not None:
        u = torch.rand((num_steps,) + tuple(p.shape), generator=generator,
                       device=p.device)
        return (u < p.unsqueeze(0)).to(torch.int8)
    err = torch.zeros_like(p)
    spikes = []
    for _ in range(num_steps):
        err = err + p
        spike = (err >= 1.0).to(torch.int8)
        err = err - spike
        spikes.append(spike)
    return torch.stack(spikes)


def rate_decode(planes: torch.Tensor, scale=1.0) -> torch.Tensor:
    """Spike-count decode for rate-coded trains (float32)."""
    num_steps = planes.shape[0]
    return planes.to(torch.float32).sum(0) * (
        _scale_like(planes, scale) / float(num_steps))


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
    levels_doc: ClassVar[str] = "?"    # the level formula in the matrix
    periods: ClassVar[int] = 1         # repeated-period count (phase: P)

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

    def representable_levels(self) -> np.ndarray:
        """Every level ``encode`` represents exactly (the image of
        ``quantize``/``requantize``): dense ``[0, max_level]`` except for
        sparse grids (TTFS)."""
        return np.arange(self.levels)

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
    backends: ClassVar[Tuple[str, ...]] = ("kernels", "jnp")
    kernel_dataflows: ClassVar[Tuple[str, ...]] = ("fused", "bitserial")
    pool_modes: ClassVar[Tuple[str, ...]] = ("or", "avg", "max")
    levels_doc: ClassVar[str] = "2^T"

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


@dataclasses.dataclass(frozen=True)
class RateEncoding(EncodingSpec):
    """Rate coding: the spike count over T steps is the level (``T + 1``
    levels).  Every step weighs 1, so only sum pooling commutes with the
    per-plane path.  No kernel dataflow: it runs on the ``jnp`` backend
    (the eager PyTorch path).  ``scale`` is a full-scale headroom factor
    ``convert`` folds into every calibrated scale."""

    scale: float = 1.0

    name: ClassVar[str] = "rate"
    backends: ClassVar[Tuple[str, ...]] = ("jnp",)
    kernel_dataflows: ClassVar[Tuple[str, ...]] = ()
    pool_modes: ClassVar[Tuple[str, ...]] = ("avg",)
    levels_doc: ClassVar[str] = "T + 1"

    def __post_init__(self):
        super().__post_init__()
        if self.scale <= 0:
            raise ValueError(f"scale must be positive, got {self.scale}")

    @property
    def levels(self) -> int:
        return self.num_steps + 1

    @property
    def scale_factor(self) -> float:
        return self.scale

    def plane_weights(self) -> np.ndarray:
        return np.ones(self.num_steps, np.int64)

    def encode(self, q):
        """Integer sigma-delta: exactly ``q`` evenly spaced spikes."""
        q = q.to(torch.int32)
        T = self.num_steps
        err = torch.zeros_like(q)
        planes = []
        for _ in range(T):
            err = err + q
            spike = (err >= T).to(torch.int8)
            err = err - spike.to(torch.int32) * T
            planes.append(spike)
        return torch.stack(planes)

    def decode(self, planes):
        return planes.to(torch.int32).sum(0, dtype=torch.int32)

    def reduce_planes(self, per_step):
        return per_step.to(torch.int32).sum(0, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class TTFSEncoding(EncodingSpec):
    """Time-to-first-spike coding: one spike at ``t = T - 1 - msb(q)``,
    decoded by the radix weights to ``2^msb(q)``; the level grid is
    ``{0, 1, 2, ..., 2^(T-1)}`` out of a ``2^T``-unit full scale.
    ``quantize``/``requantize`` floor onto that grid, and the kernels'
    epilogue does the same (``out_grid="pow2"``).  "or" pooling would
    merge one-hot trains into multi-spike ones, so only avg and max pool.
    """

    name: ClassVar[str] = "ttfs"
    backends: ClassVar[Tuple[str, ...]] = ("kernels", "jnp")
    kernel_dataflows: ClassVar[Tuple[str, ...]] = ("fused", "bitserial")
    pool_modes: ClassVar[Tuple[str, ...]] = ("avg", "max")
    levels_doc: ClassVar[str] = "T + 1 (log-spaced)"

    @property
    def levels(self) -> int:
        return 1 << self.num_steps

    @property
    def radix_planes(self) -> bool:
        return True

    def plane_weights(self) -> np.ndarray:
        return _np_radix_weights(self.num_steps)

    def representable_levels(self) -> np.ndarray:
        return np.concatenate(
            ([0], 1 << np.arange(self.num_steps, dtype=np.int64)))

    def kernel_schedule(self) -> KernelSchedule:
        return dataclasses.replace(super().kernel_schedule(),
                                   out_grid="pow2")

    def quantize(self, x, scale=1.0):
        """Radix quantize, then floor onto the power-of-two grid."""
        q = quantize(x, self.num_steps, scale)
        return pow2_floor(q, self.num_steps).to(self.packed_dtype)

    def encode(self, q):
        """One-hot planes: a single spike at the MSB of ``q``."""
        q = q.to(torch.int32)
        shifts = torch.arange(self.num_steps - 1, -1, -1, dtype=torch.int32,
                              device=q.device)
        shifts = shifts.reshape((self.num_steps,) + (1,) * q.ndim)
        return ((q.unsqueeze(0) >> shifts) == 1).to(torch.int8)

    def requantize(self, acc, mult):
        """Base requantize, then floor onto the power-of-two grid."""
        q = torch.floor(acc.to(torch.float32) * _scale_like(acc, mult))
        q = torch.clamp(q, 0, self.max_level).to(torch.int32)
        return pow2_floor(q, self.num_steps).to(self.packed_dtype)


@dataclasses.dataclass(frozen=True)
class PhaseEncoding(EncodingSpec):
    """Phase coding: ``P = periods`` repeats of ``K = T / P`` radix
    phases, ``q = sum_t 2^(K-1-(t mod K)) s_t / P`` in ``[0, 2^K - 1]``.
    The packed level is one period's ``K`` bits; the bitserial dataflow
    replays all ``P * K`` plane passes and floor-divides by ``P``.

    Raises ``ValueError`` when ``periods < 1`` or does not divide
    ``num_steps``.
    """

    periods: int = 1

    name: ClassVar[str] = "phase"
    backends: ClassVar[Tuple[str, ...]] = ("kernels", "jnp")
    kernel_dataflows: ClassVar[Tuple[str, ...]] = ("fused", "bitserial")
    pool_modes: ClassVar[Tuple[str, ...]] = ("or", "avg", "max")
    levels_doc: ClassVar[str] = "2^(T/P)"

    def __post_init__(self):
        super().__post_init__()
        if self.periods < 1:
            raise ValueError(f"periods must be >= 1, got {self.periods}")
        if self.num_steps % self.periods:
            raise ValueError(
                f"num_steps={self.num_steps} must be divisible by "
                f"periods={self.periods} (each period spans "
                f"num_steps/periods phases)")

    @property
    def phases(self) -> int:
        """Phases per period (``K = num_steps / periods``)."""
        return self.num_steps // self.periods

    @property
    def packed_bits(self) -> int:
        return self.phases

    @property
    def levels(self) -> int:
        return 1 << self.phases

    @property
    def radix_planes(self) -> bool:
        return self.periods == 1

    def plane_weights(self) -> np.ndarray:
        return np.tile(_np_radix_weights(self.phases), self.periods)

    def encode(self, q):
        """One period's MSB-first bit planes, tiled ``periods`` times."""
        planes = encode(q, self.phases)
        return planes.repeat((self.periods,) + (1,) * (planes.ndim - 1))


SPECS: Tuple[type, ...] = (RadixEncoding, RateEncoding, TTFSEncoding,
                           PhaseEncoding)
"""Every shipped :class:`EncodingSpec` subclass, in documentation order."""


def support_matrix() -> list:
    """The specs' declared capabilities: one dict per spec with ``name``,
    ``levels`` (formula), ``backends``, ``kernel_dataflows`` and
    ``pool_modes``."""
    return [dict(name=cls.name, levels=cls.levels_doc,
                 backends=cls.backends,
                 kernel_dataflows=cls.kernel_dataflows,
                 pool_modes=cls.pool_modes) for cls in SPECS]


def support_matrix_markdown() -> str:
    """:func:`support_matrix` as a markdown table."""
    fmt = "| {:<8} | {:<18} | {:<13} | {:<17} | {:<12} |".format
    lines = [fmt("encoding", "levels (T steps)", "backends",
                 "kernel dataflows", "pool modes"),
             "|" + "|".join("-" * n for n in (10, 20, 15, 19, 14)) + "|"]
    for row in support_matrix():
        join = lambda t: ", ".join(t) if t else "—"
        lines.append(fmt(row["name"], row["levels"], join(row["backends"]),
                         join(row["kernel_dataflows"]),
                         join(row["pool_modes"])))
    return "\n".join(lines)
