"""repro_torch.api — the public execution surface (port of ``repro/api.py``).

::

    from repro_torch import api

    qnet = api.convert(static, params, calib, encoding=api.RadixEncoding(4))
    exe = api.Accelerator(dataflow="fused").compile(
        qnet, item_shape, buckets=(1, 8))
    logits = exe(images)                       # any batch size, on the card
    exe.traffic(), exe.stats()

:class:`Accelerator` owns the *where/how* (device, in-kernel dataflow);
the spec owns the *what*.  ``compile`` returns an :class:`Executable`, a
batch-polymorphic callable over a bucketed plan cache.  :func:`oracle` is
the reference forward (``mode="snn"`` spike planes or ``mode="packed"``)
every plan is bit-exact against.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (where the kernels' plain versions run).  Not ported in
this slice: ``backend="jnp"``, ``parallel > 1``, ``autotune=True``,
``memory()``, the PPA stats provider and the LM path (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import conversion, engine
from repro_torch.core.conversion import QuantizedNet, convert
from repro_torch.core.encoding import (
    EncodingSpec,
    KernelSchedule,
    RadixEncoding,
)

__all__ = [
    "EncodingSpec",
    "KernelSchedule",
    "RadixEncoding",
    "QuantizedNet",
    "Accelerator",
    "Executable",
    "convert",
    "oracle",
]

BACKENDS = ("kernels",)


def _resolve_device(device) -> torch.device:
    """``None`` means the CUDA device; raises when CUDA is requested but
    absent, instead of running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "kernels' plain versions on the CPU")
    return device


def _resolve_spec(qnet: conversion.QuantizedNet,
                  encoding: Optional[EncodingSpec]) -> EncodingSpec:
    """The spec a net runs under; an override must match the algebra the
    net's multipliers were folded for."""
    if encoding is None:
        return qnet.spec
    if qnet.encoding is not None and encoding != qnet.encoding:
        raise ValueError(
            f"net was converted for {qnet.encoding}; cannot execute it as "
            f"{encoding} — reconvert with convert(..., encoding=...)")
    if (encoding.num_steps != qnet.num_steps
            or encoding.levels != qnet.spec.levels):
        raise ValueError(
            f"{encoding} ({encoding.levels} levels) does not match the "
            f"net's folded multipliers ({qnet.spec.levels} levels, "
            f"T={qnet.num_steps}) — reconvert with convert(..., "
            f"encoding=...)")
    return encoding


def oracle(qnet: conversion.QuantizedNet, x, *, mode: str = "snn",
           encoding: Optional[EncodingSpec] = None) -> torch.Tensor:
    """Reference forward on the device of ``x`` (numpy input: the CPU).

    ``mode="snn"`` is the paper-faithful spike-plane path, ``"packed"``
    the quantized-ANN twin; every :class:`Executable` is bit-exact against
    both.  Returns float logits ``(batch, classes)``.
    """
    if mode not in ("packed", "snn"):
        raise ValueError(f"mode must be 'packed' or 'snn', got {mode!r}")
    spec = _resolve_spec(qnet, encoding)
    with torch.no_grad():
        return engine._forward(qnet, torch.as_tensor(x, dtype=torch.float32),
                               spec, mode)


class Executable:
    """A compiled, batch-polymorphic deployment of one converted net.

    Produced by :meth:`Accelerator.compile`.  ``exe(x)`` maps float images
    of any batch size to float logits on the executable's device: requests
    pad up to the smallest bucket or chunk by the top one, so no request
    size builds a plan on the hot path.
    """

    def __init__(self, qnet: conversion.QuantizedNet,
                 item_shape: Tuple[int, ...], encoding: EncodingSpec,
                 dataflow: str, buckets: Sequence[int],
                 device: torch.device):
        self.qnet = qnet                     # strong ref: exe keeps net alive
        self.item_shape = tuple(int(d) for d in item_shape)
        self.encoding = encoding
        self.dataflow = dataflow
        self.device = device
        self._cache = engine.PlanCache(buckets, method=dataflow,
                                       encoding=encoding, device=device)
        self.buckets = self._cache.buckets

    def __repr__(self) -> str:
        return (f"Executable({self.encoding}, dataflow={self.dataflow!r}, "
                f"item={self.item_shape}, buckets={self.buckets}, "
                f"device={self.device})")

    @property
    def num_steps(self) -> int:
        return self.encoding.num_steps

    def __call__(self, x) -> torch.Tensor:
        """(n,) + item_shape float images -> (n, classes) float logits.
        Raises ``ValueError`` on an item shape other than the compiled one."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if tuple(x.shape[1:]) != self.item_shape:
            raise ValueError(
                f"request item shape {tuple(x.shape[1:])} != executable's "
                f"{self.item_shape}")
        with torch.no_grad():
            return self._cache.run(self.qnet, x)

    def warmup(self) -> "Executable":
        """Build every bucket's plan and run it once; returns self."""
        with torch.no_grad():
            self._cache.warmup(self.qnet, self.item_shape)
        return self

    def plan_for(self, bucket: int) -> engine.CompiledPlan:
        """The per-bucket plan (built on first use)."""
        return self._cache.plan_for(self.qnet, bucket, self.item_shape)

    def stats(self) -> dict:
        """Plan-cache counters (``hits``/``compiles``/``executions``/
        ``padded_rows``/``pruned``/``failures``), the sparsity-prepass
        counters ``plane_passes_skipped``/``plane_passes_total``, and an
        ``autotune`` sub-dict with each (bucket, kernel layer)'s strategy."""
        d = self._cache.stats.as_dict()
        d.update(self._cache.plane_stats())
        d["autotune"] = {"enabled": False,
                         "layers": self._cache.tuned_tiles()}
        return d

    def traffic(self) -> dict:
        """Modeled inter-layer activation bytes, fused packed-uint8 plan vs
        the unfused int32 baseline, for one ``buckets[0]``-sized batch."""
        return self.plan_for(self.buckets[0]).activation_traffic()


@dataclasses.dataclass(frozen=True)
class Accelerator:
    """The execution target: the kernels backend on ``device`` (``None``
    means CUDA) with the in-kernel ``dataflow`` ("fused" default,
    "bitserial" the paper-faithful schedule)."""

    backend: str = "kernels"
    dataflow: Optional[str] = None
    device: Optional[str] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r} "
                "(the jnp backend is not ported)")

    def compile(self, qnet: conversion.QuantizedNet,
                input_spec: Sequence[int], *,
                encoding: Optional[EncodingSpec] = None,
                parallel: Optional[int] = None,
                buckets: Optional[Sequence[int]] = None,
                autotune: bool = False) -> Executable:
        """Compile ``qnet`` for the per-item input shape ``input_spec``;
        ``buckets`` is the batch ladder (default ``engine.DEFAULT_BUCKETS``).

        Raises ``RuntimeError`` when the device is CUDA and none exists,
        ``ValueError`` for an encoding/dataflow/pool mismatch, and
        ``NotImplementedError`` for ``parallel > 1`` or ``autotune=True``.
        """
        if parallel not in (None, 1):
            raise NotImplementedError(
                "parallel > 1 (multi-GPU bucket plans) is not ported yet "
                "(ROADMAP.md, queue 1 item 7)")
        if autotune:
            raise NotImplementedError(
                "autotune=True is not ported yet (ROADMAP.md, queue 1 "
                "item 10)")
        device = _resolve_device(self.device)
        spec = _resolve_spec(qnet, encoding)
        if self.backend not in spec.backends:
            raise ValueError(
                f"{spec.name} encoding does not run on the "
                f"{self.backend!r} backend (supported: {spec.backends})")
        dataflow = spec.validate_dataflow(self.dataflow)
        spec.validate_static(qnet.static)
        return Executable(qnet, input_spec, spec, dataflow,
                          engine.DEFAULT_BUCKETS if buckets is None
                          else buckets, device)
