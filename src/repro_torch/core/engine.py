"""Execution engine (port of ``repro/core/engine.py``: ``_forward``,
``_compile_plan_impl``, ``CompiledPlan``, ``PlanCache``, ``LMPlanCache``).

* :func:`_forward` — the reference forward: ``mode="packed"`` runs integer
  levels through the quantized twins, ``mode="snn"`` runs ``(T, ...)``
  spike planes reduced per layer by the encoding (radix: Horner).
* :func:`_compile_plan_impl` — the controller's program memory: a one-time
  pass that moves weights to the device, folds bias + requantization
  multiplier into per-layer epilogue rows and returns a
  :class:`CompiledPlan` running the whole network through the radix
  kernels with activations kept as packed uint8 levels between layers.
* :class:`PlanCache` — the batch-bucket ladder: requests pad up to the
  smallest bucket or chunk by the top one, and the counters prove zero
  steady-state recompiles.
* :class:`LMPlanCache` — the LM's sequence-bucket ladder: one prefill plan
  per bucket and one decode-step plan.
* :func:`memory_report` — the paper's ping-pong buffer sizing and memory
  access counts (Sec. III-C), a static model in plain Python.

PyTorch runs eagerly, so a "compile" here builds the plan's closures and
device-resident parameters; the CUDA kernels themselves are built once
per process at first launch.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import conversion, encoding, layers

__all__ = ["CompiledPlan", "PlanLayerInfo", "PlanCache", "PlanCacheStats",
           "LMPlanCache", "DEFAULT_BUCKETS", "LayerMem", "MemoryReport",
           "memory_report"]


# ---------------------------------------------------------------------------
# Reference forward (packed and spike-plane paths).
# ---------------------------------------------------------------------------


def _forward(qnet: conversion.QuantizedNet, x: torch.Tensor,
             spec: encoding.EncodingSpec, mode: str = "packed") -> torch.Tensor:
    """Reference forward on ``x``'s device, generic over the encoding:
    ``mode="packed"`` on integer levels, ``mode="snn"`` on spike planes.
    Bit-exact twins by linearity."""
    snn = mode == "snn"
    q = spec.quantize(x, qnet.input_scale)
    state = spec.encode(q) if snn else q

    for (kind, cfg), qp in zip(qnet.static, qnet.qlayers):
        if kind == "conv":
            stride, padding = cfg.get("stride", 1), cfg.get("padding", "VALID")
            if snn:
                per = layers._per_plane(
                    lambda p, w=qp["w_q"]: layers._int_conv(
                        p, w, stride, padding), state)
                acc = spec.reduce_planes(per) + qp["b_int"].to(x.device)
            else:
                acc = layers.q_conv2d(state, qp["w_q"], qp["b_int"],
                                      stride=stride, padding=padding)
            state = _requant_or_logits(acc, qp, qnet, spec, snn)
        elif kind == "linear":
            if snn:
                per = layers._int_matmul(state, qp["w_q"])
                acc = spec.reduce_planes(per) + qp["b_int"].to(x.device)
            else:
                acc = layers.q_linear(state, qp["w_q"], qp["b_int"])
            state = _requant_or_logits(acc, qp, qnet, spec, snn)
        elif kind == "pool":
            state = _pool(state, cfg, spec, snn)
        elif kind == "flatten":
            if snn:
                state = state.reshape(state.shape[0], state.shape[1], -1)
            else:
                state = state.reshape(state.shape[0], -1)
        else:
            raise ValueError(kind)
    return state


def _logits(acc: torch.Tensor, logit_scale) -> torch.Tensor:
    scale = torch.as_tensor(logit_scale, dtype=torch.float32,
                            device=acc.device)
    return acc.to(torch.float32) * scale


def _requant_or_logits(acc, qp, qnet, spec, snn):
    if qp["mult"] is None:
        return _logits(acc, qnet.logit_scale)
    q = spec.requantize(acc, qp["mult"])
    return spec.encode(q) if snn else q


def _pool(state, cfg, spec, snn):
    w, pool_mode = cfg["window"], cfg.get("mode", "or")
    if not spec.supports_pool(pool_mode):
        raise ValueError(
            f"{spec.name} encoding does not preserve pool mode "
            f"{pool_mode!r} (supported: {spec.pool_modes})")
    if snn:
        if pool_mode == "or":
            return layers.snn_or_pool(state, w)
        if pool_mode == "avg":
            return layers._per_plane(lambda p: layers.q_avg_pool(p, w), state)
        if pool_mode == "max":
            if spec.radix_planes:
                packed = layers.snn_max_pool(state, w)
            else:
                packed = layers.q_max_pool(
                    spec.decode(state).to(spec.packed_dtype), w)
            return spec.encode(packed)
        raise ValueError(pool_mode)
    if pool_mode == "or":
        return layers.q_or_pool(state, w)
    if pool_mode == "avg":
        return layers.q_avg_pool(state, w)
    if pool_mode == "max":
        return layers.q_max_pool(state, w)
    raise ValueError(pool_mode)


# ---------------------------------------------------------------------------
# Compiled execution plans.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanLayerInfo:
    """Per-layer summary + the activation-traffic model."""

    name: str
    out_shape: Tuple[int, ...]     # logical output, incl. batch
    out_dtype: str                 # what the plan writes
    act_write_bytes: int           # this plan (fused epilogue, packed uint8)
    act_write_bytes_int32: int     # unfused baseline (raw int32 accumulator)


@dataclasses.dataclass
class CompiledPlan:
    """A whole-network kernel pipeline over device-resident parameters.

    ``plan(x)`` maps float input of ``input_shape`` (on the plan's device)
    to float logits, bit-exact with ``_forward(..., mode="packed")``.  Each
    call also runs the plane-occupancy prepass; the planes skipped
    accumulate on the device (no sync until :meth:`plane_stats`) against
    the static per-call budget ``plane_passes_per_call``.
    """

    input_shape: Tuple[int, ...]
    num_steps: int
    method: str
    layers: List[PlanLayerInfo]
    device: torch.device
    _fn: Callable = dataclasses.field(repr=False)
    plane_passes_per_call: int = 0
    _skipped: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                         repr=False)
    _calls: int = dataclasses.field(default=0, repr=False)
    tuned_tiles: List[dict] = dataclasses.field(default_factory=list)
    """Per kernel layer: the layer name and its ``KernelConfig`` fields."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out, skipped = self._fn(x)
        self._skipped = skipped if self._skipped is None \
            else self._skipped + skipped
        self._calls += 1
        return out

    def plane_stats(self) -> dict:
        """Planes skipped (all-zero spike planes) vs the static schedule
        total over every call so far.  Reading this syncs the device."""
        skipped = 0 if self._skipped is None else int(self._skipped.sum())
        return {"plane_passes_skipped": skipped,
                "plane_passes_total": self._calls * self.plane_passes_per_call}

    def reset_plane_stats(self) -> None:
        self._skipped = None
        self._calls = 0

    def activation_traffic(self) -> dict:
        """Modeled inter-layer activation bytes written: fused vs unfused."""
        fused = sum(l.act_write_bytes for l in self.layers)
        unfused = sum(l.act_write_bytes_int32 for l in self.layers)
        return {
            "layers": [dataclasses.asdict(l) for l in self.layers],
            "fused_write_bytes": fused,
            "int32_write_bytes": unfused,
            "traffic_ratio": unfused / max(fused, 1),
        }


def _compile_plan_impl(
    qnet: conversion.QuantizedNet,
    input_shape: Tuple[int, ...],
    *,
    method: Optional[str] = "fused",
    spec: Optional[encoding.EncodingSpec] = None,
    device="cpu",
    autotune: bool = False,
) -> CompiledPlan:
    """Compile ``qnet`` into a radix-kernel pipeline on ``device``.

    One-time work: weights and epilogue rows (bias + multiplier) move to
    the device; the avg-pool carry (activations wider than T bits, the
    window division folded into the next multiplier) is tracked so the
    bitserial extraction stays exact; the encoding's
    :class:`~repro_torch.core.encoding.KernelSchedule` is threaded into
    every kernel call.

    Every layer runs the plane-occupancy prepass on its packed input; the
    kernels skip (bitserial) or mask (fused) the empty planes and the skip
    count accumulates on the device.

    The reference pads channels to Pallas block multiples and scatters the
    first linear layer's weight rows to the padded flatten layout, only
    because Pallas blocks need aligned shapes.  The CUDA kernels mask their
    own ragged edges, so this plan keeps logical channel counts and has
    neither the padding nor the scatter.  What it does prepare once, in
    their place, is the K-major copy of every weight the int8 tensor cores
    read (``kernels.gemm.matmul_kmajor`` / ``conv_kmajor``); the plan holds
    no other copy.

    ``autotune=True`` picks each conv and linear layer's launch (tile and
    split-K) by timing ``kernels.autotune``'s candidates here, at compile
    time, on seeded levels of the layer's input shape, and reuses cached
    winners.  Every candidate gives the same integers.  ``tuned_tiles``
    records per layer the launch that runs: on CUDA its resolved tile and
    split, with the sweep's times when one ran.
    """
    from repro_torch.kernels import autotune as autotune_mod
    from repro_torch.kernels import gemm, ops as kops
    from repro_torch.kernels.autotune import KernelConfig
    from repro_torch.kernels.radix_conv import (radix_conv2d_cuda,
                                                radix_conv2d_plain)
    from repro_torch.kernels.radix_matmul import (radix_matmul_cuda,
                                                  radix_matmul_plain)

    device = torch.device(device)
    spec = spec if spec is not None else qnet.spec
    method = spec.validate_dataflow(method)
    sched = spec.kernel_schedule()
    T = sched.packed_bits
    periods = sched.periods
    kernel_kw = dict(method=method, periods=periods)
    epi_kw = dict(out_steps=T, out_level=sched.out_level,
                  out_grid=sched.out_grid)

    if len(input_shape) == 4:
        batch, h, w, c = input_shape
    elif len(input_shape) == 2:
        batch, f = input_shape
        h = w = c = None
    else:
        raise ValueError(f"input_shape must be NHWC or NF, got {input_shape}")

    bits = T                       # integer bits carried by activations
    steps: List[Callable] = []
    infos: List[PlanLayerInfo] = []
    tuned: List[dict] = []
    total_passes = 0

    def _elems(shape) -> int:
        return int(np.prod(shape))

    def _occ(state, in_bits):
        """Plane-occupancy prepass: the kernels' occupancy row and the plane
        passes they skip (bitserial) or mask (fused), on the device."""
        row, occ_bits = kops.plane_occupancy(state, in_bits)
        return row, (in_bits - occ_bits.sum()) * periods

    tune_rng = np.random.default_rng(0)   # the sweep's stand-in levels
    sms = gemm.device_sms(device)

    def _tune_sample(shape, nbits):
        """Seeded levels standing in for a layer's input in the sweep,
        uniform over the level range (every plane occupied)."""
        dt = np.uint8 if nbits <= 8 else np.int32
        return torch.from_numpy(tune_rng.integers(
            0, 1 << nbits, shape, dtype=dt)).to(device)

    def _kernel(cuda_fn, plain_fn, kcfg):
        """The function a layer calls and its extra arguments."""
        if kcfg.impl == "cuda":
            return cuda_fn, {"config": kcfg}
        return plain_fn, {}

    def _resolve(name, key_fn, cand_fn, build, in_shape, in_bits, mnk):
        """One layer's launch: the tuned winner (swept here, eagerly) or
        the untuned default, recorded in ``tuned_tiles`` as it runs."""
        sweep = []
        if autotune:
            sample = _tune_sample(in_shape, in_bits)
            kcfg = autotune_mod.tune(
                key_fn(), cand_fn(),
                lambda c: (lambda: build(c)(sample)[0]),
                on_result=lambda c, us: sweep.append(
                    {**c.as_dict(), "us": us}))
        else:
            kcfg = KernelConfig()
        row = {"layer": name, "tuned": bool(autotune), **kcfg.as_dict()}
        if kcfg.impl == "cuda" and sms is not None:
            launch = kcfg.launch(*mnk, sms)
            row.update(bm=launch.tile.act, bn=launch.tile.w,
                       bk=launch.tile.bk, split=launch.split)
        if sweep:
            row["sweep"] = sweep
        tuned.append(row)
        return kcfg

    def _record(name, out_shape, last):
        infos.append(PlanLayerInfo(
            name=name, out_shape=out_shape,
            out_dtype="int32" if last else "uint8",
            act_write_bytes=_elems(out_shape) * (4 if last else 1),
            act_write_bytes_int32=_elems(out_shape) * 4))

    for (kind, cfg), qp in zip(qnet.static, qnet.qlayers):
        if kind in ("conv", "linear"):
            w_q = qp["w_q"].to(device=device, dtype=torch.int8)
            last = qp["mult"] is None
            in_bits = bits
            if last:
                b = qp["b_int"].to(device=device, dtype=torch.int32)
                rows = {}
            else:
                bias_row, mult_row = kops.epilogue_rows(
                    qp["b_int"], qp["mult"], w_q.shape[-1], w_q.shape[-1],
                    encoding=spec, device=device)
                rows = dict(bias=bias_row, mult=mult_row, **epi_kw)
            total_passes += in_bits * periods

        if kind == "conv":
            kh, kw, cin, cout = w_q.shape
            assert cin == c, (cin, c)
            w_k = gemm.conv_kmajor(w_q)
            stride = cfg.get("stride", 1)
            in_shape = (batch, h, w, c)
            pads = None
            if cfg.get("padding", "VALID") == "SAME":
                ph = kops.same_pads(h, kh, stride)
                pw = kops.same_pads(w, kw, stride)
                pads = (0, 0, pw[0], pw[1], ph[0], ph[1])
                h, w = h + sum(ph), w + sum(pw)
            hp, wp = h, w
            h = (h - kh) // stride + 1
            w = (w - kw) // stride + 1
            c = cout

            def build_conv(kcfg, *, pads=pads, w_k=w_k, in_bits=in_bits,
                           stride=stride, rows=rows, last=last,
                           b=b if last else None):
                kfn, extra = _kernel(radix_conv2d_cuda, radix_conv2d_plain,
                                     kcfg)

                def apply(state):
                    if pads is not None:
                        state = F.pad(state, pads)
                    state = state.contiguous()
                    occ, skipped = _occ(state, in_bits)
                    out = kfn(state, w_k, num_steps=in_bits, stride=stride,
                              occupancy=occ, kmajor=True, **kernel_kw,
                              **rows, **extra)
                    return (out + b if last else out), skipped
                return apply

            name = f"conv{kh}x{kw}x{cin}->{cout}" + (
                f"/s{stride}" if stride > 1 else "")
            layer_sched = encoding.KernelSchedule(
                packed_bits=in_bits, periods=periods,
                out_grid=sched.out_grid)
            kcfg = _resolve(
                name,
                lambda: autotune_mod.conv_key(
                    hp, wp, cin, kh, kw, cout, stride, layer_sched, method,
                    batch=batch, epilogue=not last, sparsity=True,
                    backend=device),
                lambda: autotune_mod.conv_candidates(
                    hp, wp, cin, kh, kw, cout, stride, layer_sched, method,
                    batch=batch, backend=device, sms=sms),
                build_conv, in_shape, in_bits,
                (batch * h * w, cout, kh * kw * cin))
            _record(name, (batch, h, w, cout), last)
            steps.append(build_conv(kcfg))
            bits = T

        elif kind == "linear":
            fin, fout = w_q.shape
            assert fin == f, (fin, f)
            f = fout
            w_k = gemm.matmul_kmajor(w_q)

            def build_linear(kcfg, *, w_k=w_k, in_bits=in_bits, rows=rows,
                             last=last, b=b if last else None):
                kfn, extra = _kernel(radix_matmul_cuda, radix_matmul_plain,
                                     kcfg)

                def apply(state):
                    state = state.contiguous()
                    occ, skipped = _occ(state, in_bits)
                    out = kfn(state, w_k, num_steps=in_bits, occupancy=occ,
                              kmajor=True, **kernel_kw, **rows, **extra)
                    return (out + b if last else out), skipped
                return apply

            name = f"linear{fin}->{fout}"
            layer_sched = encoding.KernelSchedule(
                packed_bits=in_bits, periods=periods,
                out_grid=sched.out_grid)
            kcfg = _resolve(
                name,
                lambda: autotune_mod.matmul_key(
                    batch, fin, fout, layer_sched, method,
                    epilogue=not last, sparsity=True, backend=device),
                lambda: autotune_mod.matmul_candidates(
                    batch, fin, fout, layer_sched, method, backend=device,
                    sms=sms),
                build_linear, (batch, fin), in_bits, (batch, fout, fin))
            _record(name, (batch, fout), last)
            steps.append(build_linear(kcfg))
            bits = T

        elif kind == "pool":
            window, pool_mode = cfg["window"], cfg.get("mode", "or")
            h, w = h // window, w // window
            if pool_mode == "avg":
                # the sum-pool widens the carry; it stays packed while it
                # fits a byte
                bits = layers.sum_pool_bits(bits, window)
                packed = bits <= 8

                def apply(state, *, window=window, packed=packed):
                    out = layers.q_avg_pool(state, window)
                    return (out.to(torch.uint8) if packed else out), None
            elif pool_mode in ("or", "max"):
                fn = (layers.q_or_pool if pool_mode == "or"
                      else layers.q_max_pool)

                def apply(state, *, fn=fn, window=window):
                    return fn(state, window), None
            else:
                raise ValueError(pool_mode)
            steps.append(apply)
            nbytes = 1 if bits <= 8 else 4
            out_shape = (batch, h, w, c)
            infos.append(PlanLayerInfo(
                name=f"pool{window}/{pool_mode}", out_shape=out_shape,
                out_dtype="uint8" if nbytes == 1 else "int32",
                act_write_bytes=_elems(out_shape) * nbytes,
                act_write_bytes_int32=_elems(out_shape) * 4))

        elif kind == "flatten":
            steps.append(lambda state: (state.reshape(state.shape[0], -1),
                                        None))
            f = h * w * c
        else:
            raise ValueError(kind)

    # plain locals, not qnet attribute reads: the closure must not hold the
    # net, or the plan cache's weakref never dies
    input_scale = qnet.input_scale
    logit_scale = qnet.logit_scale
    if torch.is_tensor(logit_scale):
        logit_scale = logit_scale.to(device)

    def forward(x):
        state = spec.quantize(x, input_scale)
        skipped = torch.zeros((1,), dtype=torch.int64, device=device)
        for apply in steps:
            state, sk = apply(state)
            if sk is not None:
                skipped = skipped + sk
        return _logits(state, logit_scale), skipped

    return CompiledPlan(
        input_shape=tuple(input_shape),
        num_steps=T,
        method=method,
        layers=infos,
        device=device,
        _fn=forward,
        plane_passes_per_call=total_passes,
        tuned_tiles=tuned,
    )


# plan-cache keys hold a weakref to the net: two refs compare equal only
# while both resolve to the same live net, so a collected net's recycled
# id() never aliases a stale entry (QuantizedNet hashes by identity)
def _cache_key(qnet, *rest) -> tuple:
    return (weakref.ref(qnet),) + rest


def _weakref_cache_get(cache: dict, key, qnet):
    hit = cache.get(key)
    if hit is not None and hit[0]() is qnet:
        return hit[1]
    return None


def _weakref_cache_prune(cache: dict) -> int:
    """Drop entries whose net died; returns the number dropped."""
    stale = [k for k, (r, _) in cache.items() if r() is None]
    for k in stale:
        del cache[k]
    return len(stale)


# ---------------------------------------------------------------------------
# Batch-bucketing plan cache.
# ---------------------------------------------------------------------------


DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 32, 128)


@dataclasses.dataclass
class PlanCacheStats:
    """Counters proving steady-state serving never recompiles."""

    hits: int = 0            # plan served from cache
    compiles: int = 0        # plan builds (cache misses)
    pruned: int = 0          # entries dropped after their net was collected
    executions: int = 0      # plan calls (chunks count individually)
    padded_rows: int = 0     # bucket-padding rows executed and sliced off
    failures: int = 0        # run() calls that raised

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlanCache:
    """Batch-bucketing compiled-plan cache (wrapped by ``api.Executable``).

    Plans are built for a fixed ascending bucket ladder.  A request of
    ``n`` items pads up to the smallest bucket ``>= n`` (zero rows, sliced
    off after the call) or, above the top bucket, chunks into top-bucket
    pieces plus one bucketed tail.  Entries are keyed by (weakref(net),
    bucket, item shape, method, encoding) and die with the net.

    ``compile_fn(qnet, input_shape) -> plan`` replaces the kernel plan
    compiler; ``api`` passes one for the ``jnp`` backend, whose per-bucket
    plans share the bucketing, chunking and counters with kernel plans.
    ``autotune`` tunes each kernel plan's layers as it is built.
    A plan is called on the padded batch and has ``plane_stats()``,
    ``reset_plane_stats()`` and ``tuned_tiles``, as ``CompiledPlan`` does.
    """

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS, *,
                 method: str = "fused",
                 encoding: Optional[encoding.EncodingSpec] = None,
                 device="cpu", compile_fn: Optional[Callable] = None,
                 autotune: bool = False):
        bs = tuple(sorted({int(b) for b in buckets}))
        if not bs or bs[0] < 1:
            raise ValueError(f"bucket ladder must be positive, got {buckets}")
        self.buckets = bs
        self.method = method
        self.encoding = encoding
        self.device = torch.device(device)
        self._compile_fn = compile_fn
        self.autotune = bool(autotune)
        self.stats = PlanCacheStats()
        self._plans: dict = {}

    def __len__(self) -> int:
        return len(self._plans)

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (top bucket for oversize chunk tails)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def prune(self) -> int:
        n = _weakref_cache_prune(self._plans)
        self.stats.pruned += n
        return n

    def plane_stats(self) -> dict:
        """Sparsity-prepass counters summed over every live cached plan."""
        out = {"plane_passes_skipped": 0, "plane_passes_total": 0}
        for _, plan in self._plans.values():
            for k, v in plan.plane_stats().items():
                out[k] += v
        return out

    def tuned_tiles(self) -> List[dict]:
        """Per (bucket, kernel layer): the strategy each plan uses."""
        return [{"bucket": key[1], **row}
                for key, (_, plan) in self._plans.items()
                for row in plan.tuned_tiles]

    def plan_for(self, qnet: conversion.QuantizedNet, bucket: int,
                 item_shape: Tuple[int, ...]) -> CompiledPlan:
        """Cached plan for one bucket (built on first use)."""
        key = _cache_key(qnet, int(bucket), tuple(item_shape),
                         self.method, self.encoding)
        plan = _weakref_cache_get(self._plans, key, qnet)
        if plan is not None:
            self.stats.hits += 1
            return plan
        self.prune()
        shape = (int(bucket),) + tuple(item_shape)
        if self._compile_fn is not None:
            plan = self._compile_fn(qnet, shape)
        else:
            plan = _compile_plan_impl(qnet, shape, method=self.method,
                                      spec=self.encoding, device=self.device,
                                      autotune=self.autotune)
        self._plans[key] = (weakref.ref(qnet), plan)
        self.stats.compiles += 1
        return plan

    def warmup(self, qnet: conversion.QuantizedNet,
               item_shape: Tuple[int, ...]) -> List[CompiledPlan]:
        """Build the whole ladder and run each plan once on zeros (which
        also builds the CUDA kernels), then zero the sparsity counters."""
        plans = [self.plan_for(qnet, b, item_shape) for b in self.buckets]
        for b, plan in zip(self.buckets, plans):
            plan(torch.zeros((b,) + tuple(item_shape), dtype=torch.float32,
                             device=self.device))
            plan.reset_plane_stats()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return plans

    def run(self, qnet: conversion.QuantizedNet,
            x: torch.Tensor) -> torch.Tensor:
        """Arbitrary-batch inference: pad to the nearest bucket or chunk by
        the top bucket, slice the logits back to the request size.  A
        raised build or execution error counts in ``stats.failures``."""
        try:
            return self._run(qnet, x)
        except Exception:
            self.stats.failures += 1
            raise

    def _run(self, qnet, x):
        n = x.shape[0]
        item = tuple(x.shape[1:])
        top = self.buckets[-1]
        outs = []
        off = 0
        while n - off > top:
            outs.append(self.plan_for(qnet, top, item)(x[off:off + top]))
            self.stats.executions += 1
            off += top
        rem = n - off
        bucket = self.bucket_for(rem)
        tail = x[off:]
        if bucket > rem:
            tail = torch.cat([tail, tail.new_zeros((bucket - rem,) + item)])
            self.stats.padded_rows += bucket - rem
        outs.append(self.plan_for(qnet, bucket, item)(tail)[:rem])
        self.stats.executions += 1
        return outs[0] if len(outs) == 1 else torch.cat(outs)


class LMPlanCache:
    """Sequence-bucketed plan cache for autoregressive LM serving (wrapped
    by ``api.LMExecutable``).

    Two plan families: one **prefill** plan per sequence bucket (prompts
    right-pad to the smallest bucket ``>= S0``; the model gathers the
    last-token logits at the true length) and ONE **decode-step** plan for
    every generated token.  A plan is the eager closure the injected
    builder returns, built once; ``compiles`` counts builds, so serving
    tests assert zero steady-state builds as on the CNN path.
    ``padded_rows`` counts padded prompt columns plus padded batch rows.
    """

    def __init__(self, seq_buckets: Sequence[int], *,
                 prefill_builder: Callable, decode_builder: Callable):
        bs = tuple(sorted({int(b) for b in seq_buckets}))
        if not bs or bs[0] < 1:
            raise ValueError(
                f"sequence-bucket ladder must be positive, got {seq_buckets}")
        self.buckets = bs
        self._prefill_builder = prefill_builder
        self._decode_builder = decode_builder
        self.stats = PlanCacheStats()
        self._prefill_plans: dict = {}
        self._decode_plan = None

    def bucket_for(self, s: int) -> int:
        """Smallest sequence bucket >= s; longer prompts are an error (the
        KV cache is sized by the compile-time ``max_len``)."""
        if s < 1:
            raise ValueError(f"prompt length must be >= 1, got {s}")
        for b in self.buckets:
            if b >= s:
                return b
        raise ValueError(
            f"prompt length {s} exceeds the top sequence bucket "
            f"{self.buckets[-1]}; recompile with a longer bucket ladder")

    def prefill_plan(self, bucket: int):
        """Cached prefill plan for one sequence bucket (built on first
        use)."""
        plan = self._prefill_plans.get(int(bucket))
        if plan is not None:
            self.stats.hits += 1
            return plan
        plan = self._prefill_builder(int(bucket))
        self._prefill_plans[int(bucket)] = plan
        self.stats.compiles += 1
        return plan

    def decode_plan(self):
        """The one cached decode-step plan (built on first use)."""
        if self._decode_plan is None:
            self._decode_plan = self._decode_builder()
            self.stats.compiles += 1
        else:
            self.stats.hits += 1
        return self._decode_plan

    def record_execution(self, *, padded_rows: int = 0) -> None:
        """Count one plan call (and any pad rows/columns it carried)."""
        self.stats.executions += 1
        self.stats.padded_rows += int(padded_rows)


# ---------------------------------------------------------------------------
# Ping-pong buffer sizing and memory-access accounting.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerMem:
    name: str
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    act_bits: int                 # bits per activation element (T, packed)
    weight_bytes: int             # parameter bytes at weight_bits resolution
    act_reads: int                # activation elements read (with row reuse)
    act_writes: int
    weight_reads: int             # weight elements fetched (row reuse: once
                                  # per (out-row, time step) per kernel row)


@dataclasses.dataclass
class MemoryReport:
    layers: List[LayerMem]
    buf2d_bytes: int              # ping + pong 2-D activation buffers
    buf1d_bytes: int              # ping + pong 1-D activation buffers
    weight_bram_bytes: int        # on-chip weight storage if it fits
    needs_dram: bool              # paper: VGG-11 streams weights from DRAM
    total_param_bytes: int

    @property
    def total_buffer_bytes(self) -> int:
        return self.buf2d_bytes + self.buf1d_bytes


def memory_report(qnet: conversion.QuantizedNet,
                  input_hw: Tuple[int, int, int], *,
                  bram_capacity_bytes: int = 8 << 20) -> MemoryReport:
    """Static ping-pong sizing and access counts for one inference (batch
    1), as Sec. III-C lays them out: two 2-D buffers sized to the largest
    conv/pool feature map (T bits per element, packed), two 1-D buffers for
    the linear layers; weights on chip iff they fit
    ``bram_capacity_bytes``.  A model of the paper's accelerator, not of
    the card."""
    T = qnet.num_steps
    h, w, c = input_hw
    shape: Tuple[int, ...] = (h, w, c)
    layer_mems: List[LayerMem] = []
    max2d = int(np.prod(shape))
    max1d = 0
    total_param_bytes = 0

    for (kind, cfg), qp in zip(qnet.static, qnet.qlayers):
        in_shape = shape
        if kind == "conv":
            kh, kw, cin, cout = (int(d) for d in qp["w_q"].shape)
            stride = cfg.get("stride", 1)
            if cfg.get("padding", "VALID") == "SAME":
                ho = -(-shape[0] // stride)
                wo = -(-shape[1] // stride)
            else:
                ho = (shape[0] - kh) // stride + 1
                wo = (shape[1] - kw) // stride + 1
            shape = (ho, wo, cout)
            wbytes = math.ceil(kh * kw * cin * cout * qnet.weight_bits / 8)
            total_param_bytes += wbytes
            layer_mems.append(LayerMem(
                name=f"conv{kh}x{kw}x{cin}->{cout}",
                in_shape=in_shape, out_shape=shape, act_bits=T,
                weight_bytes=wbytes,
                # row-based reuse: each input row read once per (out-channel
                # pass, time step); kernel rows re-fetched per output row
                act_reads=T * cin * shape[0] * in_shape[1] * kh,
                act_writes=int(np.prod(shape)),
                weight_reads=T * cin * cout * kh * kw * shape[0]))
            max2d = max(max2d, int(np.prod(shape)))
        elif kind == "linear":
            fin, fout = (int(d) for d in qp["w_q"].shape)
            shape = (fout,)
            wbytes = math.ceil(fin * fout * qnet.weight_bits / 8)
            total_param_bytes += wbytes
            layer_mems.append(LayerMem(
                name=f"linear{fin}->{fout}",
                in_shape=in_shape, out_shape=shape, act_bits=T,
                weight_bytes=wbytes, act_reads=T * fin, act_writes=fout,
                weight_reads=T * fin * fout))
            max1d = max(max1d, fin, fout)
        elif kind == "pool":
            win = cfg["window"]
            shape = (shape[0] // win, shape[1] // win, shape[2])
            layer_mems.append(LayerMem(
                name=f"pool{win}", in_shape=in_shape, out_shape=shape,
                act_bits=T, weight_bytes=0,
                act_reads=T * int(np.prod(in_shape)),
                act_writes=int(np.prod(shape)), weight_reads=0))
            max2d = max(max2d, int(np.prod(shape)))
        elif kind == "flatten":
            shape = (int(np.prod(shape)),)
            max1d = max(max1d, shape[0])

    buf2d = 2 * math.ceil(max2d * T / 8)          # ping + pong, T-bit packed
    buf1d = 2 * math.ceil(max1d * T / 8)
    needs_dram = total_param_bytes > bram_capacity_bytes
    return MemoryReport(
        layers=layer_mems, buf2d_bytes=buf2d, buf1d_bytes=buf1d,
        weight_bram_bytes=0 if needs_dram else total_param_bytes,
        needs_dram=needs_dram, total_param_bytes=total_param_bytes)
