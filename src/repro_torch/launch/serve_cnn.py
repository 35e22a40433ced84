"""Batched SNN/CNN inference serving over compiled plans (port of
``repro/launch/serve_cnn.py``).

Three layers:

1. **Compiled executable** (``repro_torch.api.Accelerator.compile`` ->
   ``Executable``): plans built for a bucket ladder; requests pad to the
   nearest bucket, so no request size builds a plan on the hot path.
2. **Micro-batching queue** (:class:`MicroBatchQueue`): requests collect
   until the batch is full or the oldest request times out, then flush as
   one plan call.
3. **Resilience** (policy objects in ``repro_torch.runtime.resilience``):
   bounded admission with backpressure, deadlines that shed expired
   tickets, **bisecting quarantine** of a failing flush (a poison request
   is isolated in O(log n) re-flushes and fails alone after a bounded
   retry budget while its co-batched tickets complete), and a healthy ->
   degraded -> draining health machine over per-flush latencies.  Every
   shed or failed ticket resolves with a typed ``ServeError``; the
   ``rejected / shed / retried / quarantined / degraded_flushes``
   counters ride along in ``server.stats()``.

The encoding is chosen on the command line (``--encoding`` with
``--num-steps``/``--periods``): radix, TTFS and phase serve plans through
the CUDA radix kernels; rate serves the eager ``jnp``-backend plans.
A flush synchronises the device inside its ``try``, so a device error
surfaces in the group that caused it and a flush's latency includes the
device's work.

Weights are drawn with numpy from ``--seed`` (the reference draws them
with ``jax.random``, so one seed gives other weights in the two
packages); the calibration batch is the reference's.  Plans run on the
CUDA device unless ``--device cpu`` is given.  ``--auto`` lets the PPA
planner (``repro_torch.ppa``) pick the encoding, T, dataflow and unit
count under ``--accuracy-floor`` / ``--latency-slo`` / ``--energy-budget``
(the latter two on the paper's modeled FPGA build), searching on the same
device.  ``--data-parallel k`` splits each bucket over up to k visible
devices (``api.Accelerator.compile(parallel=k)``).

Usage:
  python -m repro_torch.launch.serve_cnn --arch vgg11 --smoke
  python -m repro_torch.launch.serve_cnn --arch lenet5 --requests 64 \\
      --buckets 1,4,8
  python -m repro_torch.launch.serve_cnn --arch lenet5 --smoke \\
      --encoding phase --num-steps 8 --periods 2 --dataflow bitserial
  python -m repro_torch.launch.serve_cnn --arch fang_cnn --smoke \\
      --encoding ttfs --pool-mode avg --dataflow bitserial --device cpu
  python -m repro_torch.launch.serve_cnn --arch lenet5 --smoke --auto \\
      --pool-mode avg --accuracy-floor 0.3 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import conversion, engine
from repro_torch.runtime import resilience

__all__ = [
    "ARCHS",
    "ENCODINGS",
    "make_encoding",
    "build_float_net",
    "build_qnet",
    "CNNServer",
    "MicroBatchQueue",
    "Ticket",
    "run_request_stream",
    "main",
]


# CLI name -> spec constructor; phase is the only one with an extra knob
ENCODINGS = {
    "radix": api.RadixEncoding,
    "rate": api.RateEncoding,
    "ttfs": api.TTFSEncoding,
    "phase": api.PhaseEncoding,
}


def make_encoding(name: str, num_steps: int, *,
                  periods: int = 1) -> api.EncodingSpec:
    """Build a spec from CLI-style arguments.  ``periods`` applies to
    phase coding only; passing it with another encoding raises."""
    if name not in ENCODINGS:
        raise ValueError(
            f"encoding must be one of {sorted(ENCODINGS)}, got {name!r}")
    if name == "phase":
        return api.PhaseEncoding(num_steps, periods=periods)
    if periods != 1:
        raise ValueError(
            f"--periods applies to phase coding only, not {name!r}")
    return ENCODINGS[name](num_steps)


# ---------------------------------------------------------------------------
# Architecture registry (the paper's three CNNs).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """``make()`` kwargs for the full config and the CPU smoke config:
    kwargs dicts, or the name of a dict attribute on ``module``."""

    module: str
    full: "dict | str" = dataclasses.field(default_factory=dict)
    smoke: "dict | str" = dataclasses.field(default_factory=dict)


ARCHS = {
    "lenet5": ArchSpec("repro_torch.models.lenet",
                       smoke={"width_mult": 0.25}),
    "fang_cnn": ArchSpec("repro_torch.models.fang",
                         smoke={"width_mult": 0.25}),
    "vgg11": ArchSpec("repro_torch.models.vgg",
                      full={"input_hw": (224, 224, 3)},
                      smoke="SMOKE_KWARGS"),
}


def build_float_net(arch: str, *, smoke: bool = False, pool_mode: str = "or",
                    calib_batch: int = 4, seed: int = 0):
    """(static, params, item shape, calibration batch) for an arch id, on
    the CPU: He weights from ``numpy.random.default_rng(seed)`` and the
    reference's calibration batch (uniform [0, 1) from the same seed)."""
    spec = ARCHS[arch.replace("-", "_")]
    maker = importlib.import_module(spec.module)
    preset = spec.smoke if smoke else spec.full
    if isinstance(preset, str):
        preset = getattr(maker, preset)
    static, params, input_hw = maker.make(
        np.random.default_rng(seed), pool_mode=pool_mode, **dict(preset))
    rng = np.random.default_rng(seed)
    calib = torch.from_numpy(
        rng.uniform(0, 1, (calib_batch,) + tuple(input_hw))
        .astype(np.float32))
    return static, params, tuple(input_hw), calib


def build_qnet(arch: str, *, smoke: bool = False, pool_mode: str = "or",
               num_steps: Optional[int] = None,
               encoding: Optional[api.EncodingSpec] = None,
               weight_bits: int = 3, calib_batch: int = 4, seed: int = 0,
               device=None) -> Tuple[conversion.QuantizedNet,
                                     Tuple[int, int, int]]:
    """(converted net, item shape) for an arch id, converted on ``device``
    (``None``: the CUDA device).  ``encoding`` selects the spec (default:
    radix at ``num_steps``, itself defaulting to 4); a contradicting pair
    fails in ``convert``."""
    if encoding is None and num_steps is None:
        num_steps = 4
    dev = api._resolve_device(device)
    static, params, input_hw, calib = build_float_net(
        arch, smoke=smoke, pool_mode=pool_mode, calib_batch=calib_batch,
        seed=seed)
    params = [None if p is None else {k: v.to(dev) for k, v in p.items()}
              for p in params]
    with torch.no_grad():
        qnet = conversion.convert(static, params, calib.to(dev),
                                  num_steps=num_steps, encoding=encoding,
                                  weight_bits=weight_bits)
    return qnet, input_hw


# ---------------------------------------------------------------------------
# Server: executable + request entry point.
# ---------------------------------------------------------------------------


class CNNServer:
    """One converted net behind a compiled :class:`repro_torch.api.Executable`.

    Buckets, plan caching and the stats counters live on the executable
    (``server.exe``); the resilience counters (``resilience``, mutated by
    the server's :class:`MicroBatchQueue`) are attached to its stats, so
    ``server.stats()`` reports both."""

    def __init__(self, qnet: conversion.QuantizedNet,
                 item_shape: Tuple[int, ...], *,
                 buckets: Sequence[int] = engine.DEFAULT_BUCKETS,
                 dataflow: Optional[str] = None, backend: str = "kernels",
                 data_parallel: Optional[int] = None,
                 executable: Optional[api.Executable] = None, device=None):
        self.qnet = qnet
        self.item_shape = tuple(item_shape)
        self.exe = executable if executable is not None else api.Accelerator(
            backend=backend, dataflow=dataflow, device=device,
        ).compile(qnet, self.item_shape, parallel=data_parallel,
                  buckets=buckets)
        self.resilience = resilience.ResilienceStats()
        self.exe.attach_stats(self.resilience.as_dict)

    def warmup(self) -> None:
        """Build every bucket's plan up front (serving never builds one)."""
        self.exe.warmup()

    def stats(self) -> dict:
        return self.exe.stats()

    def infer(self, x) -> torch.Tensor:
        """(n,) + item_shape float images -> (n, classes) float logits on
        the executable's device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.exe.device)
        if tuple(x.shape[1:]) != self.item_shape:
            raise ValueError(
                f"request item shape {tuple(x.shape[1:])} != server's "
                f"{self.item_shape}")
        return self.exe(x)


def _block_until_ready(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t`` (a device error raises
    here, inside the caller's ``try``)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# ---------------------------------------------------------------------------
# Micro-batching request queue.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ticket:
    """Handle returned by :meth:`MicroBatchQueue.submit`.

    A ticket always reaches a terminal state: ``result`` holds the logits,
    or ``error`` holds a :class:`~repro_torch.runtime.resilience.ServeError`
    (rejected at submit, shed on deadline, or quarantined as poisoned).
    ``deadline`` is an absolute queue-clock time."""

    size: int
    t_submit: float
    deadline: Optional[float] = None      # absolute clock time; None = none
    result: Optional[torch.Tensor] = None
    error: Optional[Exception] = None     # terminal ServeError
    latency_s: Optional[float] = None     # submit -> resolved (either way)

    @property
    def done(self) -> bool:
        """Terminal: resolved with logits OR a typed error."""
        return self.result is not None or self.error is not None

    @property
    def ok(self) -> bool:
        """Resolved successfully (logits available)."""
        return self.result is not None


ADMISSION_POLICIES = ("reject", "flush")


class MicroBatchQueue:
    """Fault-tolerant collect-until-full-or-timeout micro-batcher.

    Requests accumulate; the queue flushes as **one** batched
    ``server.infer`` call when the pending image count reaches
    ``max_batch`` or the oldest request has waited ``timeout_s``.

    * **Bounded admission** — ``pending_images`` never exceeds
      ``max_pending``.  An over-bound submit resolves at once with an
      ``AdmissionError``, or with ``admission="flush"`` the queue flushes
      synchronously to make room first.
    * **Deadlines** — an expired ticket is shed (``DeadlineExceeded``)
      before it reaches a flush, and around every retry backoff.
    * **Bisecting quarantine** — a failing flush is split in half and the
      halves re-flushed, so one poisoned request is isolated in O(log n)
      re-flushes; alone, it gets a bounded ``RetryPolicy`` budget for
      transient faults and then resolves with ``RequestPoisoned``, while
      every healthy co-batched ticket completes.
    * **Health machine** — per-flush latencies feed a ``HealthMonitor``.
      A faulting flush group counts as exactly *one* unhealthy sample,
      however many sub-flushes and retries its recovery takes.  Degraded
      serving flushes in groups of at most ``degraded_max_batch`` images;
      draining refuses admissions until ``health.resume()``.

    Single-threaded and event-driven: callers drive time through
    :meth:`submit` / :meth:`poll` (``clock`` and the backoff ``sleep`` are
    injectable, so chaos tests are deterministic).  A ticket's latency
    spans its original submit to its resolution, through any retries.
    """

    def __init__(
        self,
        server: CNNServer,
        *,
        max_batch: Optional[int] = None,
        timeout_s: float = 0.005,
        clock: Callable[[], float] = time.monotonic,
        max_pending: Optional[int] = None,
        admission: str = "reject",
        default_deadline_s: Optional[float] = None,
        retry: Optional[resilience.RetryPolicy] = resilience.RetryPolicy(),
        health: Optional[resilience.HealthMonitor] = None,
        degraded_max_batch: Optional[int] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.server = server
        self.max_batch = int(max_batch or server.exe.buckets[-1])
        self.timeout_s = float(timeout_s)
        self.clock = clock
        if admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"admission must be one of {ADMISSION_POLICIES}, got "
                f"{admission!r}")
        self.admission = admission
        self.max_pending = int(max_pending if max_pending is not None
                               else 8 * self.max_batch)
        if self.max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {self.max_pending}")
        self.default_deadline_s = default_deadline_s
        self.retry = retry
        self.health = health if health is not None \
            else resilience.HealthMonitor()
        if degraded_max_batch is None:
            smaller = [b for b in server.exe.buckets if b < self.max_batch]
            degraded_max_batch = smaller[-1] if smaller else self.max_batch
        self.degraded_max_batch = max(1, int(degraded_max_batch))
        self._sleep = sleep
        self.counters = getattr(server, "resilience", None)
        if self.counters is None:
            self.counters = resilience.ResilienceStats()
        self._pending: List[Tuple[np.ndarray, Ticket]] = []
        self._count = 0
        self.flushes = 0          # successful infer flushes (incl. halves)

    @property
    def pending_images(self) -> int:
        return self._count

    def _reject(self, ticket: Ticket, reason: str) -> Ticket:
        ticket.error = resilience.AdmissionError(reason)
        ticket.latency_s = 0.0
        self.counters.rejected += 1
        return ticket

    def submit(self, x, *, deadline_s: Optional[float] = None) -> Ticket:
        """Enqueue one request (an item or an (n,)+item batch); may flush.

        A malformed request raises ``ValueError`` here (a caller bug),
        never poisoning tickets already queued.  An admission failure is
        a fault: the returned ticket resolves at once with an
        ``AdmissionError``.  ``deadline_s`` (default
        ``default_deadline_s``) is relative to now."""
        x = np.asarray(x, np.float32)
        if x.ndim == len(self.server.item_shape):
            x = x[None]
        if tuple(x.shape[1:]) != self.server.item_shape:
            raise ValueError(
                f"request item shape {tuple(x.shape[1:])} != server's "
                f"{self.server.item_shape}")
        if x.shape[0] == 0:
            raise ValueError("empty request (0 images)")
        now = self.clock()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        ticket = Ticket(size=x.shape[0], t_submit=now,
                        deadline=None if deadline_s is None
                        else now + deadline_s)
        if not self.health.accepting:
            return self._reject(
                ticket, f"server draining (health={self.health.state}); "
                "not accepting new requests")
        if self._count + ticket.size > self.max_pending:
            if self.admission == "flush":
                self.flush()          # backpressure: drain to make room
            if self._count + ticket.size > self.max_pending:
                return self._reject(
                    ticket, f"queue at admission bound: {self._count} "
                    f"pending + {ticket.size} > max_pending="
                    f"{self.max_pending}")
        self._pending.append((x, ticket))
        self._count += ticket.size
        self.poll(now)
        return ticket

    def _shed_if_expired(self, ticket: Ticket,
                         now: Optional[float] = None) -> bool:
        """Resolve ``ticket`` with ``DeadlineExceeded`` if its deadline
        passed; True if shed."""
        now = self.clock() if now is None else now
        if ticket.deadline is None or now < ticket.deadline:
            return False
        ticket.error = resilience.DeadlineExceeded(
            f"deadline passed {now - ticket.deadline:.4f}s ago")
        ticket.latency_s = now - ticket.t_submit
        self.counters.shed += 1
        return True

    def _shed_expired(self, now: float) -> None:
        """Resolve-and-drop every pending ticket whose deadline passed."""
        if all(t.deadline is None for _, t in self._pending):
            return
        kept = []
        for x, ticket in self._pending:
            if self._shed_if_expired(ticket, now):
                self._count -= ticket.size
            else:
                kept.append((x, ticket))
        self._pending = kept

    def poll(self, now: Optional[float] = None) -> bool:
        """Shed expired tickets, then flush if full or the oldest request
        timed out; True if flushed."""
        now = self.clock() if now is None else now
        self._shed_expired(now)
        if not self._pending:
            return False
        oldest = self._pending[0][1].t_submit
        if self._count >= self.max_batch or now - oldest >= self.timeout_s:
            self.flush()
            return True
        return False

    def flush(self) -> None:
        """Run everything pending; every involved ticket reaches a
        terminal state.  Never raises on an infer fault."""
        self._shed_expired(self.clock())
        if not self._pending:
            return
        pending, self._pending, self._count = self._pending, [], 0
        if self.health.degraded:
            groups = self._split(pending, self.degraded_max_batch)
        else:
            groups = [pending]
        for group in groups:
            if self._run_group(group):
                # one fault event is ONE unhealthy sample, however many
                # sub-flushes and retries isolating it took
                self.health.record_failure()

    @staticmethod
    def _split(pending, cap: int):
        """Greedy FIFO grouping at <= cap images per group (a request
        larger than cap keeps its own group; requests are never split)."""
        groups, cur, n = [], [], 0
        for x, ticket in pending:
            if cur and n + ticket.size > cap:
                groups.append(cur)
                cur, n = [], 0
            cur.append((x, ticket))
            n += ticket.size
        if cur:
            groups.append(cur)
        return groups

    def _run_group(self, group) -> bool:
        """One batched infer over ``group``; on failure, bisect (several
        tickets) or retry-then-quarantine (one ticket).  True if any
        infer attempt in the subtree faulted."""
        batch = group[0][0] if len(group) == 1 else np.concatenate(
            [x for x, _ in group], axis=0)
        if self.health.degraded:
            self.counters.degraded_flushes += 1
        t0 = self.clock()
        try:
            logits = self.server.infer(batch)
            _block_until_ready(logits)
        except Exception as err:
            if len(group) > 1:
                mid = len(group) // 2
                self._run_group(group[:mid])
                self._run_group(group[mid:])
                return True
            self._retry_single(group[0], err)
            return True
        self._resolve(group, logits, t0)
        return False

    def _retry_single(self, item, err: Exception) -> None:
        """Bounded backoff retries for an isolated ticket; shed the
        moment its deadline passes (before and after each backoff),
        quarantine on an exhausted budget."""
        x, ticket = item
        budget = self.retry.max_retries if self.retry is not None else 0
        for attempt in range(budget):
            if self._shed_if_expired(ticket):
                return
            self.counters.retried += 1
            self._sleep(self.retry.backoff(attempt))
            if self._shed_if_expired(ticket):
                return
            t0 = self.clock()
            try:
                logits = self.server.infer(x)
                _block_until_ready(logits)
            except Exception as again:
                err = again
                continue
            self._resolve([item], logits, t0)
            return
        poisoned = resilience.RequestPoisoned(
            f"request of {ticket.size} image(s) failed alone after "
            f"{budget} retries: {err}")
        poisoned.__cause__ = err
        ticket.error = poisoned
        ticket.latency_s = self.clock() - ticket.t_submit
        self.counters.quarantined += 1

    def _resolve(self, group, logits, t0: float) -> None:
        done = self.clock()
        self.flushes += 1
        self.health.record_flush(done - t0)
        off = 0
        for x, ticket in group:
            ticket.result = logits[off:off + x.shape[0]]
            ticket.latency_s = done - ticket.t_submit
            off += x.shape[0]


# ---------------------------------------------------------------------------
# Request streams (CLI, chip_smoke.py).
# ---------------------------------------------------------------------------


def run_request_stream(queue: MicroBatchQueue, sizes: Sequence[int], *,
                       seed: int = 0, drain: bool = True,
                       deadline_s: Optional[float] = None) -> List[Ticket]:
    """Submit a stream of uniform [0, 1) requests of the given sizes
    (numpy, from ``seed``); returns the tickets, all terminal when
    ``drain`` flushes at the end."""
    rng = np.random.default_rng(seed)
    item = queue.server.item_shape
    tickets = [queue.submit(rng.uniform(0, 1, (int(n),) + item)
                            .astype(np.float32), deadline_s=deadline_s)
               for n in sizes]
    if drain:
        queue.flush()
    return tickets


def _percentiles(latencies_ms: Sequence[float]) -> Tuple[float, float]:
    return (float(np.percentile(latencies_ms, 50)),
            float(np.percentile(latencies_ms, 95)))


def _parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse and validate CLI args (``ArgumentParser.error`` -> exit 2,
    naming the offending value).  The bucket ladder is returned as
    ``args.bucket_ladder``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--pool-mode", default="or", choices=["or", "avg", "max"],
                    help="rate needs avg; ttfs needs avg/max (the spec "
                         "validates loudly)")
    ap.add_argument("--num-steps", type=int, default=None,
                    help="total time steps T, default 4 (phase: all "
                         "periods)")
    ap.add_argument("--encoding", default=None, choices=sorted(ENCODINGS),
                    help="target neural encoding; default radix")
    ap.add_argument("--periods", type=int, default=None,
                    help="phase coding: repeated periods P (T/P phases); "
                         "default 1")
    ap.add_argument("--backend", default=None, choices=["kernels", "jnp"],
                    help="default: kernels when the encoding supports it, "
                         "else jnp (the eager PyTorch path)")
    ap.add_argument("--device", default=None,
                    help="torch device for conversion and plans; default "
                         "cuda (cpu runs the kernels' plain versions)")
    ap.add_argument("--buckets", default="1,8,32",
                    help="comma-separated batch bucket ladder (strictly "
                         "ascending positive ints)")
    ap.add_argument("--dataflow", default=None,
                    choices=["fused", "bitserial"],
                    help="in-kernel dataflow (kernels backend; default: "
                         "the encoding's first declared dataflow)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-request", type=int, default=8,
                    help="request sizes drawn uniformly from [1, this]")
    ap.add_argument("--timeout-ms", type=float, default=2.0)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline; expired tickets are shed "
                         "with DeadlineExceeded")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="admission bound on pending images (default "
                         "8 x max batch)")
    ap.add_argument("--admission", default="reject",
                    choices=sorted(ADMISSION_POLICIES),
                    help="over-bound submits: reject with AdmissionError, "
                         "or flush (synchronous backpressure)")
    ap.add_argument("--retries", type=int, default=2,
                    help="retry budget for an isolated failing request "
                         "before quarantine")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="split each bucket over up to this many visible "
                         "devices (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--auto", action="store_true",
                    help="let the PPA planner pick encoding/T/dataflow/"
                         "units under the constraints below")
    ap.add_argument("--accuracy-floor", type=float, default=None,
                    help="--auto: minimum calibration-batch fidelity vs "
                         "the float reference (default 0.9)")
    ap.add_argument("--latency-slo", type=float, default=None,
                    help="--auto: modeled per-image latency ceiling (us, "
                         "the paper's FPGA build)")
    ap.add_argument("--energy-budget", type=float, default=None,
                    help="--auto: modeled per-image energy ceiling (uJ, "
                         "the paper's FPGA build)")
    args = ap.parse_args(argv)

    if args.auto:
        for flag, val in (("--encoding", args.encoding),
                          ("--dataflow", args.dataflow),
                          ("--backend", args.backend),
                          ("--num-steps", args.num_steps),
                          ("--periods", args.periods)):
            if val is not None:
                ap.error(f"{flag} conflicts with --auto (the planner "
                         "owns that axis)")
        if args.accuracy_floor is None:
            args.accuracy_floor = 0.9
        if not 0.0 < args.accuracy_floor <= 1.0:
            ap.error(f"--accuracy-floor must be in (0, 1], got "
                     f"{args.accuracy_floor}")
        if args.latency_slo is not None and args.latency_slo <= 0:
            ap.error(f"--latency-slo must be positive, got "
                     f"{args.latency_slo}")
        if args.energy_budget is not None and args.energy_budget <= 0:
            ap.error(f"--energy-budget must be positive, got "
                     f"{args.energy_budget}")
    else:
        for flag, val in (("--accuracy-floor", args.accuracy_floor),
                          ("--latency-slo", args.latency_slo),
                          ("--energy-budget", args.energy_budget)):
            if val is not None:
                ap.error(f"{flag} is a planner constraint and requires "
                         "--auto")
    if args.encoding is None:
        args.encoding = "radix"
    if args.num_steps is None:
        args.num_steps = 4
    if args.periods is None:
        args.periods = 1

    if args.num_steps <= 0:
        ap.error(f"--num-steps must be positive, got {args.num_steps}")
    if args.requests <= 0:
        ap.error(f"--requests must be positive, got {args.requests}")
    if args.max_request <= 0:
        ap.error(f"--max-request must be positive, got {args.max_request}")
    if args.timeout_ms < 0:
        ap.error(f"--timeout-ms must be >= 0, got {args.timeout_ms}")
    if args.deadline_ms is not None and args.deadline_ms <= 0:
        ap.error(f"--deadline-ms must be positive, got {args.deadline_ms}")
    if args.max_pending is not None and args.max_pending < 1:
        ap.error(f"--max-pending must be >= 1, got {args.max_pending}")
    if args.retries < 0:
        ap.error(f"--retries must be >= 0, got {args.retries}")
    if args.data_parallel is not None and args.data_parallel < 1:
        ap.error(
            f"--data-parallel must be >= 1, got {args.data_parallel}")
    try:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    except ValueError:
        ap.error(f"--buckets must be comma-separated ints, got "
                 f"{args.buckets!r}")
    if not buckets or any(b < 1 for b in buckets) or \
            list(buckets) != sorted(set(buckets)):
        ap.error("--buckets must be strictly ascending positive ints "
                 f"(no duplicates), got {args.buckets!r}")
    args.bucket_ladder = buckets
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Serve a seeded request stream; prints the summary and returns it
    (requests, images, wall seconds, p50/p95 ms, stats, health, flushes,
    and the planner's ``AutoPlan`` under ``--auto``, else None)."""
    args = _parse_args(argv)
    buckets = args.bucket_ladder
    plan = None
    if args.auto:
        static, params, item, calib = build_float_net(
            args.arch, smoke=args.smoke, pool_mode=args.pool_mode,
            calib_batch=64, seed=args.seed)
        plan = api.autoconfigure(
            (static, params), item, calib=calib,
            accuracy_floor=args.accuracy_floor,
            latency_slo_us=args.latency_slo,
            energy_budget_uj=args.energy_budget, device=args.device)
        print("[serve_cnn] " + plan.summary().replace("\n", "\n[serve_cnn] "))
        exe = plan.compile(buckets=buckets, parallel=args.data_parallel)
        server = CNNServer(exe.qnet, item, executable=exe)
        spec, backend = exe.encoding, exe.backend
    else:
        spec = make_encoding(args.encoding, args.num_steps,
                             periods=args.periods)
        backend = args.backend or ("kernels" if "kernels" in spec.backends
                                   else "jnp")
        qnet, item = build_qnet(args.arch, smoke=args.smoke,
                                pool_mode=args.pool_mode, encoding=spec,
                                seed=args.seed, device=args.device)
        server = CNNServer(qnet, item, buckets=buckets, backend=backend,
                           dataflow=args.dataflow, device=args.device)
    print(f"[serve_cnn] {args.arch} {spec} backend={backend} item={item} "
          f"buckets={buckets} device={server.exe.device}")
    t0 = time.monotonic()
    server.warmup()
    print(f"[serve_cnn] warmed {len(buckets)} bucket plans in "
          f"{time.monotonic() - t0:.1f}s; "
          f"compiles={server.stats()['compiles']}")

    queue = MicroBatchQueue(
        server, timeout_s=args.timeout_ms / 1e3,
        max_pending=args.max_pending, admission=args.admission,
        default_deadline_s=None if args.deadline_ms is None
        else args.deadline_ms / 1e3,
        retry=resilience.RetryPolicy(max_retries=args.retries))
    rng = np.random.default_rng(args.seed)
    sizes = rng.integers(1, args.max_request + 1, args.requests)
    t0 = time.monotonic()
    tickets = run_request_stream(queue, sizes, seed=args.seed)
    wall = time.monotonic() - t0
    ok = [t for t in tickets if t.ok]
    lat = [t.latency_s * 1e3 for t in ok]
    p50, p95 = _percentiles(lat) if lat else (float("nan"), float("nan"))
    images = int(sum(t.size for t in ok))
    stats = server.stats()
    print(f"[serve_cnn] {len(tickets)} requests / {images} images served in "
          f"{wall:.2f}s -> {images / wall:.1f} img/s; "
          f"latency p50={p50:.1f}ms p95={p95:.1f}ms")
    print(f"[serve_cnn] cache: hits={stats['hits']} "
          f"compiles={stats['compiles']} (steady-state recompiles="
          f"{stats['compiles'] - len(server.exe.buckets)}) "
          f"padded_rows={stats['padded_rows']} flushes={queue.flushes}")
    print(f"[serve_cnn] resilience: health={queue.health.state} "
          f"rejected={stats['rejected']} shed={stats['shed']} "
          f"retried={stats['retried']} quarantined={stats['quarantined']} "
          f"degraded_flushes={stats['degraded_flushes']} "
          f"failures={stats['failures']}")
    return dict(requests=len(tickets), ok=len(ok), images=images,
                wall_s=wall, p50_ms=p50, p95_ms=p95, stats=stats,
                health=queue.health.state, flushes=queue.flushes, plan=plan)


if __name__ == "__main__":
    main()
