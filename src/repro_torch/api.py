"""repro_torch.api — the public execution surface (port of ``repro/api.py``).

::

    from repro_torch import api

    qnet = api.convert(static, params, calib, encoding=api.RadixEncoding(4))
    exe = api.Accelerator(dataflow="fused").compile(
        qnet, item_shape, buckets=(1, 8))
    logits = exe(images)                       # any batch size, on the card
    exe.traffic(), exe.stats()

    rate = api.convert(static, params, calib, encoding=api.RateEncoding(4))
    exe = api.Accelerator(backend="jnp").compile(rate, item_shape)

    lm = api.Accelerator(dataflow="fused").compile(
        (params, cfg), (batch, max_len), buckets=(64, 256))
    tokens = lm.generate(prompts, max_new=32)  # or lm.prefill / lm.decode

:class:`Accelerator` owns the *where/how* (device, backend, in-kernel
dataflow); the spec (:class:`RadixEncoding`, :class:`RateEncoding`,
:class:`TTFSEncoding`, :class:`PhaseEncoding`) owns the *what*.
``backend="kernels"`` runs compiled plans through the CUDA radix kernels;
``backend="jnp"`` (the reference's name, kept so its support matrix
carries over) runs the eager PyTorch reference path per bucket, and is
the only backend for rate coding.  ``compile`` returns an
:class:`Executable`, a batch-polymorphic callable over a bucketed plan
cache, or for a ``(params, ArchConfig)`` pair an :class:`LMExecutable`,
bucketed prefill plus one decode-step plan over the radix KV cache.
:func:`oracle` is the reference forward (``mode="snn"`` spike planes or
``mode="packed"``) every CNN plan is bit-exact against.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (where the kernels' plain versions run).
``compile(..., autotune=True)`` picks each kernel launch by timing
``kernels.autotune``'s candidates at compile time.  Not ported:
``parallel > 1``, ``auto=`` and the PPA stats provider (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import conversion, engine
from repro_torch.core.conversion import QuantizedNet, convert
from repro_torch.core.encoding import (
    SPECS,
    EncodingSpec,
    KernelSchedule,
    PhaseEncoding,
    RadixEncoding,
    RateEncoding,
    TTFSEncoding,
    support_matrix,
    support_matrix_markdown,
)
from repro_torch.lm.config import ArchConfig

__all__ = [
    "EncodingSpec",
    "KernelSchedule",
    "RadixEncoding",
    "RateEncoding",
    "TTFSEncoding",
    "PhaseEncoding",
    "SPECS",
    "support_matrix",
    "support_matrix_markdown",
    "QuantizedNet",
    "Accelerator",
    "Executable",
    "LMExecutable",
    "convert",
    "oracle",
]

BACKENDS = ("kernels", "jnp")


def _resolve_device(device) -> torch.device:
    """``None`` means the CUDA device; raises when CUDA is requested but
    absent, instead of running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "kernels' plain versions on the CPU")
    return device


def _is_lm_net(qnet) -> bool:
    """True for the LM compile form: a ``(params, ArchConfig)`` pair."""
    return (isinstance(qnet, tuple) and len(qnet) == 2
            and isinstance(qnet[1], ArchConfig))


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


def _merge_stat_providers(d: dict, providers) -> dict:
    """Merge ``attach_stats`` provider dicts into ``d``; a key that
    collides with an existing one raises instead of shadowing it."""
    for provider in providers:
        extra = provider()
        clash = sorted(set(extra) & set(d))
        if clash:
            raise ValueError(
                f"attach_stats provider key(s) {clash} collide with "
                "existing stats keys; namespace provider keys "
                "instead of shadowing core counters")
        d.update(extra)
    return d


class _EagerPlan:
    """The ``jnp`` backend's per-bucket plan: the packed reference forward
    on the input's device.  It holds the net by weakref, so the plan cache
    entry still dies with the net; it has no sparsity prepass and no
    kernel layers, so its counters are zeros and its tile list empty."""

    tuned_tiles: tuple = ()

    def __init__(self, qnet: conversion.QuantizedNet, spec: EncodingSpec):
        self._net = weakref.ref(qnet)
        self._spec = spec

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return engine._forward(self._net(), x, self._spec, "packed")

    def plane_stats(self) -> dict:
        return {"plane_passes_skipped": 0, "plane_passes_total": 0}

    def reset_plane_stats(self) -> None:
        pass


class Executable:
    """A compiled, batch-polymorphic deployment of one converted net.

    Produced by :meth:`Accelerator.compile`.  ``exe(x)`` maps float images
    of any batch size to float logits on the executable's device: requests
    pad up to the smallest bucket or chunk by the top one, so no request
    size builds a plan on the hot path.  ``backend="kernels"`` plans run
    the CUDA radix kernels; ``backend="jnp"`` plans run the eager packed
    reference forward (``dataflow`` is then None).
    """

    def __init__(self, qnet: conversion.QuantizedNet,
                 item_shape: Tuple[int, ...], encoding: EncodingSpec,
                 backend: str, dataflow: Optional[str],
                 buckets: Sequence[int], device: torch.device,
                 autotune: bool = False):
        self.qnet = qnet                     # strong ref: exe keeps net alive
        self.item_shape = tuple(int(d) for d in item_shape)
        self.encoding = encoding
        self.backend = backend
        self.dataflow = dataflow
        self.device = device
        self.autotune = bool(autotune)
        eager = backend == "jnp"
        self._cache = engine.PlanCache(
            buckets, method="jnp" if eager else dataflow, encoding=encoding,
            device=device, compile_fn=(
                lambda net, shape: _EagerPlan(net, encoding)) if eager
            else None, autotune=autotune)
        self.buckets = self._cache.buckets
        self._stat_providers: list = []

    def __repr__(self) -> str:
        return (f"Executable({self.encoding}, backend={self.backend!r}, "
                f"dataflow={self.dataflow!r}, item={self.item_shape}, "
                f"buckets={self.buckets}, device={self.device})")

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

    def plan_for(self, bucket: int):
        """The per-bucket plan (built on first use): a
        :class:`~repro_torch.core.engine.CompiledPlan` on the kernels
        backend, an eager packed forward on ``jnp``."""
        return self._cache.plan_for(self.qnet, bucket, self.item_shape)

    def attach_stats(self, provider) -> "Executable":
        """Register a zero-argument callable returning a dict that
        :meth:`stats` merges in (the serving queue's resilience counters
        use it).  A key that collides with a core counter or an earlier
        provider's key makes :meth:`stats` raise ``ValueError``.  Returns
        self."""
        self._stat_providers.append(provider)
        return self

    def stats(self) -> dict:
        """Plan-cache counters (``hits``/``compiles``/``executions``/
        ``padded_rows``/``pruned``/``failures``), the sparsity-prepass
        counters ``plane_passes_skipped``/``plane_passes_total`` (zeros on
        the ``jnp`` backend), an ``autotune`` sub-dict (``enabled``, the
        winner table's counters, each (bucket, kernel layer)'s launch),
        and any :meth:`attach_stats` dicts."""
        from repro_torch.kernels import autotune as autotune_mod

        d = self._cache.stats.as_dict()
        d.update(self._cache.plane_stats())
        d["autotune"] = {"enabled": self.autotune,
                         **autotune_mod.default_cache().stats.as_dict(),
                         "layers": self._cache.tuned_tiles()}
        return _merge_stat_providers(d, self._stat_providers)

    def traffic(self) -> dict:
        """Modeled inter-layer activation bytes, fused packed-uint8 plan vs
        the unfused int32 baseline, for one ``buckets[0]``-sized batch
        (kernels backend only)."""
        if self.backend != "kernels":
            raise NotImplementedError(
                "the activation-traffic model describes compiled kernel "
                "plans; compile with Accelerator(backend='kernels')")
        return self.plan_for(self.buckets[0]).activation_traffic()

    def memory(self, **kwargs) -> engine.MemoryReport:
        """Ping-pong buffer sizing and access counts of the paper's
        accelerator (Sec. III-C) for one image: ``engine.memory_report``."""
        if len(self.item_shape) != 3:
            raise ValueError(
                "memory() models (H, W, C) image nets, item_shape="
                f"{self.item_shape}")
        return engine.memory_report(self.qnet, self.item_shape, **kwargs)


@dataclasses.dataclass(frozen=True)
class Accelerator:
    """The execution target on ``device`` (``None`` means CUDA).

    * ``backend="kernels"``: plans through the CUDA radix kernels, with
      the in-kernel ``dataflow`` among the encoding's declared ones
      ("fused" default, "bitserial" the paper-faithful schedule);
    * ``backend="jnp"``: the eager packed reference forward per bucket,
      the only backend for encodings without a kernel dataflow (rate).
      It is a backend the caller names, never a fallback.
    """

    backend: str = "kernels"
    dataflow: Optional[str] = None
    device: Optional[str] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.dataflow is not None and self.backend != "kernels":
            raise ValueError(
                f"dataflow={self.dataflow!r} selects the in-kernel "
                "schedule and requires backend='kernels'")

    def compile(self, qnet, input_spec: Sequence[int], *,
                encoding: Optional[EncodingSpec] = None,
                parallel: Optional[int] = None,
                buckets: Optional[Sequence[int]] = None,
                autotune: bool = False, auto: Optional[dict] = None):
        """Compile ``qnet`` for the per-item input shape ``input_spec``;
        ``buckets`` is the batch ladder (default ``engine.DEFAULT_BUCKETS``).
        A ``(params, ArchConfig)`` pair compiles the LM serving path
        instead (:meth:`_compile_lm`).

        ``autotune=True`` (kernels backend) times each conv and linear
        layer's launch candidates as a bucket's plan is built and keeps the
        winners (``kernels.autotune``); every candidate gives the same
        logits.

        Raises ``RuntimeError`` when the device is CUDA and none exists,
        ``ValueError`` for an encoding/backend/dataflow/pool mismatch (and
        for ``parallel > 1`` or ``autotune=True`` off the kernels
        backend, as the reference does), and ``NotImplementedError`` for
        ``parallel > 1`` or ``auto=`` on the kernels backend.
        """
        if _is_lm_net(qnet):
            return self._compile_lm(qnet, input_spec, encoding=encoding,
                                    parallel=parallel, buckets=buckets,
                                    autotune=autotune, auto=auto)
        if auto is not None:
            raise NotImplementedError(
                "auto= (the PPA planner) is not ported yet (ROADMAP.md, "
                "queue 1 item 5)")
        spec = _resolve_spec(qnet, encoding)
        if self.backend not in spec.backends:
            raise ValueError(
                f"{spec.name} encoding does not run on the "
                f"{self.backend!r} backend (supported: {spec.backends})")
        dataflow = None
        if self.backend == "kernels":
            if parallel not in (None, 1):
                raise NotImplementedError(
                    "parallel > 1 (multi-GPU bucket plans) is not ported "
                    "yet (ROADMAP.md, queue 1 item 7)")
            dataflow = spec.validate_dataflow(self.dataflow)
        else:
            if parallel not in (None, 1):
                raise ValueError(
                    "parallel (data-parallel bucket plans) requires "
                    "backend='kernels'")
            if autotune:
                raise ValueError(
                    "autotune sweeps kernel strategies and requires "
                    "backend='kernels'")
        spec.validate_static(qnet.static)
        device = _resolve_device(self.device)
        return Executable(qnet, input_spec, spec, self.backend, dataflow,
                          engine.DEFAULT_BUCKETS if buckets is None
                          else buckets, device, autotune=autotune)

    def _compile_lm(self, qnet, input_spec, *, encoding, parallel, buckets,
                    autotune, auto) -> "LMExecutable":
        """The LM leg of :meth:`compile`: ``qnet`` is ``(params, cfg)``.

        ``input_spec`` is ``(max_len,)`` or ``(batch, max_len)``: the
        compiled decode batch and the KV-cache capacity.  ``buckets`` is the
        **sequence-length** ladder (default: powers of two from 8 up to
        ``max_len - 1``); every bucket must stay below ``max_len`` so decode
        has cache room.  The paper-technique knobs live on the ArchConfig
        (``radix_steps`` = T, ``radix_kv`` / ``radix_kv_pack``,
        ``packed_attn``, ``radix_attn``)."""
        params, cfg = qnet
        if autotune and self.backend != "kernels":
            raise ValueError(
                "autotune sweeps kernel strategies and requires "
                "backend='kernels'")
        if self.backend != "kernels":
            raise NotImplementedError(
                "the LM path's jnp backend (the reference's int8 "
                "dot_general twin) is not ported yet (ROADMAP.md, queue 1 "
                "item 3.7); use backend='kernels'")
        if auto is not None:
            raise ValueError(
                "auto= (the PPA planner) prices the paper's CNN lattice, "
                "not LM archs; configure the ArchConfig directly")
        if encoding is not None:
            raise ValueError(
                "LM serving always runs the radix encoding "
                "(cfg.radix_steps sets T); drop the encoding= override")
        if parallel not in (None, 1):
            raise ValueError(
                "parallel bucket sharding is a CNN-plan feature; LM "
                "plans shard via the model's mesh instead")
        if self.dataflow is not None and self.dataflow not in (
                "bitserial", "fused"):
            raise ValueError(
                f"LM radix matmuls support dataflow 'bitserial' or "
                f"'fused', got {self.dataflow!r}")
        device = _resolve_device(self.device)
        spec = tuple(int(d) for d in input_spec)
        if len(spec) == 1:
            batch, max_len = 1, spec[0]
        elif len(spec) == 2:
            batch, max_len = spec
        else:
            raise ValueError(
                f"LM input_spec is (max_len,) or (batch, max_len), "
                f"got {input_spec}")
        if buckets is None:
            top = max(1, max_len - 1)
            ladder = {top}
            b = 8
            while b < top:
                ladder.add(b)
                b *= 2
            buckets = tuple(sorted(ladder))
        return LMExecutable(params, cfg, batch=batch, max_len=max_len,
                            seq_buckets=buckets, dataflow=self.dataflow,
                            device=device, autotune=autotune)


class LMExecutable:
    """A compiled autoregressive LM serving deployment.

    Produced by :meth:`Accelerator.compile` from a ``(params, ArchConfig)``
    pair; do not construct directly.  The FFN matmuls (and the QKV/out
    projections under ``cfg.radix_attn``) run as radix matmuls through the
    CUDA kernel, the KV cache holds radix levels, and with
    ``cfg.packed_attn`` every decode step's attention runs the
    decode-attention kernel on those levels (``repro_torch.lm.radix``).
    On ``device="cpu"`` the kernels' plain versions run.

    Serving shape contract (an :class:`~repro_torch.core.engine.LMPlanCache`):
    prompts right-pad to a fixed sequence-bucket ladder (one prefill plan
    per bucket, last-token logits gathered at the true length) and every
    generated token reuses ONE decode-step plan over the KV cache: zero
    steady-state plan builds, as :meth:`stats` shows.  Right-padding is
    exact only for a pure full-attention stack (the causal mask hides the
    pads), so other block types are rejected at compile time.  ``decode``
    writes into the state's caches in place.
    """

    def __init__(self, params, cfg: ArchConfig, *, batch: int, max_len: int,
                 seq_buckets: Sequence[int], dataflow: Optional[str],
                 device: torch.device, autotune: bool = False):
        from repro_torch.lm import model as lm_model

        bad = sorted(set(cfg.layer_types) - {"attn"})
        if bad:
            raise ValueError(
                "the LM compile path right-pads prompts to sequence "
                "buckets, which is exact only for pure full-attention "
                f"stacks (causal masking hides the pads); block types "
                f"{bad} would absorb pad tokens into recurrent/ring state "
                "— serve those archs via repro_torch.launch.serve.generate")
        if cfg.encoder_layers or cfg.embedding_inputs:
            raise ValueError(
                "the LM compile path serves token-in/token-out decoder "
                "stacks; encoder-decoder and embedding-input archs run "
                "via repro_torch.lm.model.prefill / decode_step with a "
                "batch dict")
        serve_cfg = dataclasses.replace(
            cfg, quant="radix", use_kernel=True,
            kernel_autotune=bool(autotune),
            kernel_dataflow=dataflow or cfg.kernel_dataflow)
        lm_model.check_supported(serve_cfg)
        self.cfg = serve_cfg
        self.arch = cfg.name
        self.dataflow = serve_cfg.kernel_dataflow
        self.autotune = bool(autotune)
        self.device = device
        self.batch = int(batch)
        self.max_len = int(max_len)
        if self.batch < 1 or self.max_len < 2:
            raise ValueError(
                f"need batch >= 1 and max_len >= 2, got ({batch}, {max_len})")
        params = lm_model.tree_map(lambda t: t.to(device), params)
        self.params = lm_model.kmajor_params(
            lm_model.radixify_params(params, serve_cfg))

        mdl, mx, scfg = lm_model, self.max_len, serve_cfg

        def prefill_builder(bucket):
            def plan(p, tokens, true_len):
                with torch.inference_mode():
                    return mdl.prefill(p, {"tokens": tokens}, scfg,
                                       max_len=mx, true_len=true_len)
            return plan

        def decode_builder():
            def plan(p, caches, tok, pos):
                with torch.inference_mode():
                    return mdl.decode_step(p, caches, tok, pos, scfg)
            return plan

        self._cache = engine.LMPlanCache(
            seq_buckets, prefill_builder=prefill_builder,
            decode_builder=decode_builder)
        self.buckets = self._cache.buckets
        if self.buckets[-1] >= self.max_len:
            raise ValueError(
                f"top sequence bucket {self.buckets[-1]} must stay below "
                f"max_len={self.max_len} (the KV cache needs at least one "
                "free decode slot)")
        self._tuned_rows: list = []
        if self.autotune:
            self._tuned_rows = self._sweep()

    def _sweep(self) -> list:
        """Tune, here at compile time, every radix matmul problem the plans
        run: each weight at M = batch * bucket rows (prefill) and at M =
        batch (decode; the untied lm head only there), so the plans'
        lookups hit.  One row per (weight, M) problem, with the winner."""
        from repro_torch.core import encoding as encoding_mod
        from repro_torch.kernels import autotune as autotune_mod
        from repro_torch.kernels import ops as kops

        problems = []

        def walk(t, path=""):
            if isinstance(t, dict):
                if set(t) == {"qt", "scale"}:
                    qt = t["qt"]
                    problems.append((path, qt.reshape((-1,) + tuple(
                        qt.shape[-2:]))[0]))
                    return
                for k in sorted(t):
                    walk(t[k], f"{path}/{k}" if path else k)
            elif isinstance(t, (tuple, list)):
                for i, v in enumerate(t):
                    walk(v, f"{path}/{i}")

        walk(self.params)
        T = self.cfg.radix_steps
        method = self.cfg.kernel_dataflow
        gen = torch.Generator().manual_seed(0)
        rows, seen = [], set()
        for name, qt in problems:
            n, k = int(qt.shape[0]), int(qt.shape[1])
            ms = {self.batch} if name.endswith("unembed") else (
                {self.batch * b for b in self.buckets} | {self.batch})
            for m in sorted(ms):
                key = autotune_mod.matmul_key(
                    m, k, n, T, method, epilogue=False, sparsity=False,
                    backend=self.device)
                if key in seen:
                    continue
                seen.add(key)
                x = torch.randint(0, encoding_mod.max_level(T) + 1, (m, k),
                                  generator=gen, dtype=torch.uint8)
                kops.radix_matmul(x.to(self.device), qt, None, T,
                                  method=method, autotune=True, kmajor=True)
                win = autotune_mod.default_cache().get(key)
                rows.append({"layer": name, "m": m, "k": k, "n": n,
                             "tuned": win is not None,
                             **(win or autotune_mod.KernelConfig()).as_dict()})
        if self.cfg.packed_attn and self.cfg.radix_kv:
            rows.append(self._sweep_attn(gen))
        return rows

    def _sweep_attn(self, gen: torch.Generator) -> dict:
        """Tune the decode plan's attention problem: S = max_len over a
        synthetic radix cache (seeded levels, unit scales, every slot
        valid), so the decode plan's lookup hits."""
        from repro_torch.kernels import autotune as autotune_mod
        from repro_torch.kernels import ops as kops
        from repro_torch.lm import radix as radix_lib

        cfg, b, s_len = self.cfg, self.batch, self.max_len
        t, hkv, hd = cfg.radix_steps, cfg.n_kv_heads, cfg.hd
        g = cfg.n_heads // hkv
        packed = radix_lib._packed(cfg)
        method = cfg.kernel_dataflow
        q = torch.randn((b, hkv * g, hd), generator=gen).to(
            self.device, radix_lib.torch_dtype(cfg.dtype))
        lv = [torch.randint(0, 1 << t, (b, s_len, hkv, hd), generator=gen,
                            dtype=torch.uint8) for _ in range(2)]
        if packed:
            lv = [radix_lib._pack4(x) for x in lv]
        k_q, v_q = (x.to(self.device) for x in lv)
        scale = torch.ones((b, s_len, hkv), dtype=torch.float32,
                           device=self.device)
        mask = torch.ones((b, s_len), dtype=torch.bool, device=self.device)
        kops.radix_decode_attention(q, k_q, scale, v_q, scale, mask, t,
                                    packed=packed, method=method,
                                    autotune=True)
        win = autotune_mod.default_cache().get(autotune_mod.attn_key(
            b, s_len, hkv, g, hd, t, method, q_bits=kops.Q_BITS,
            packed=packed, sparsity=True, backend=self.device))
        return {"layer": "decode_attn", "m": b, "k": hd, "n": s_len,
                "tuned": win is not None,
                **(win or autotune_mod.KernelConfig()).as_dict()}

    def __repr__(self) -> str:
        return (f"LMExecutable({self.arch!r}, T={self.cfg.radix_steps}, "
                f"dataflow={self.dataflow!r}, batch={self.batch}, "
                f"max_len={self.max_len}, seq_buckets={self.buckets}, "
                f"device={self.device})")

    @property
    def num_steps(self) -> int:
        return self.cfg.radix_steps

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def prefill(self, prompts) -> dict:
        """Prefill ``prompts`` ((n, S0) int tokens, n <= batch) through
        the bucketed plan; returns the serving state dict
        ``{"caches", "pos", "logits", "n"}``: ``logits`` (n, vocab)
        predict the token at position S0."""
        prompts = self._tokens(prompts)
        if prompts.ndim != 2:
            raise ValueError(
                f"prompts must be (n, S0), got {tuple(prompts.shape)}")
        n, s0 = int(prompts.shape[0]), int(prompts.shape[1])
        if n > self.batch:
            raise ValueError(
                f"request batch {n} exceeds compiled batch {self.batch}")
        bucket = self._cache.bucket_for(s0)
        # +1 column: model._input_h consumes tokens[:, :-1]
        tokens = torch.zeros((self.batch, bucket + 1), dtype=torch.long,
                             device=self.device)
        tokens[:n, :s0] = prompts
        plan = self._cache.prefill_plan(bucket)
        logits, caches = plan(self.params, tokens, s0)
        self._cache.record_execution(
            padded_rows=(self.batch - n) + (bucket - s0))
        return {"caches": caches, "pos": s0, "logits": logits[:n], "n": n}

    def decode(self, state: dict, tokens) -> dict:
        """One decode step: write ``tokens`` ((n, 1) int) at
        ``state["pos"]``, return the advanced state (``logits`` predict
        position pos + 1).  The state's caches are updated in place."""
        n = state["n"]
        pos = int(state["pos"])
        if pos >= self.max_len:
            raise ValueError(
                f"decode position {pos} out of cache range "
                f"(max_len={self.max_len})")
        tok = torch.zeros((self.batch, 1), dtype=torch.long,
                          device=self.device)
        tok[:n] = self._tokens(tokens).reshape(n, 1)
        plan = self._cache.decode_plan()
        logits, caches = plan(self.params, state["caches"], tok, pos)
        self._cache.record_execution(padded_rows=self.batch - n)
        return {"caches": caches, "pos": pos + 1, "logits": logits[:n],
                "n": n}

    def generate(self, prompts, max_new: int, *, greedy: bool = True,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Autoregressive decode: (n, S0) prompts -> (n, max_new) tokens
        (greedy argmax, or samples from the softmax drawn with the
        explicit ``generator``)."""
        prompts = self._tokens(prompts)
        s0 = int(prompts.shape[1])
        if s0 + max_new - 1 > self.max_len:
            raise ValueError(
                f"prompt ({s0}) + max_new ({max_new}) tokens exceed the "
                f"compiled cache (max_len={self.max_len})")
        if not greedy and generator is None:
            raise ValueError("sampling (greedy=False) needs generator=")
        state = self.prefill(prompts)
        out = []
        for i in range(int(max_new)):
            logits = state["logits"].to(torch.float32)
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                        generator=generator)[:, 0]
            out.append(nxt)
            if i + 1 < max_new:
                state = self.decode(state, nxt[:, None])
        return torch.stack(out, dim=1)

    def warmup(self) -> "LMExecutable":
        """Build and run every prefill bucket plan and the decode-step
        plan once, so serving never builds a plan on the hot path."""
        caches = None
        for b in self.buckets:
            tokens = torch.zeros((self.batch, b + 1), dtype=torch.long,
                                 device=self.device)
            _, caches = self._cache.prefill_plan(b)(self.params, tokens, b)
        tok = torch.zeros((self.batch, 1), dtype=torch.long,
                          device=self.device)
        self._cache.decode_plan()(self.params, caches, tok, self.buckets[-1])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def stats(self) -> dict:
        """LM plan-cache counters (``hits`` / ``compiles`` / ``executions``
        / ``padded_rows`` / ``failures``: ``compiles`` stays flat in
        steady state, one prefill plan per sequence bucket plus one decode
        plan) and an ``autotune`` sub-dict: whether the compile-time sweep
        ran, the winner table's counters, and one row per swept problem
        with the launch the plans use."""
        from repro_torch.kernels import autotune as autotune_mod

        d = self._cache.stats.as_dict()
        d["autotune"] = {"enabled": self.autotune,
                         **autotune_mod.default_cache().stats.as_dict(),
                         "layers": list(self._tuned_rows)}
        return d
