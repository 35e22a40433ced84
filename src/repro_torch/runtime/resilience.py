"""Serving resilience: fault taxonomy, admission, health, chaos harness
(port of ``repro/runtime/resilience.py``, which needs only numpy).

A serving twin of the paper's accelerator is judged on how it degrades,
not just how fast it runs clean traffic (DESIGN.md §3 failure-mode
table).  This module is the policy layer `launch/serve_cnn.py`'s
micro-batch queue executes:

* **Error taxonomy** — :class:`ServeError` subclasses are the *terminal*
  states a `Ticket` can resolve into instead of dangling forever:
  :class:`AdmissionError` (rejected at submit), :class:`DeadlineExceeded`
  (shed before execution), :class:`RequestPoisoned` (quarantined after
  failing alone through the retry budget).
* **RetryPolicy** — bounded retry budget with exponential backoff for
  transient faults (the sleep is injected by the queue, so tests drive
  it with a fake clock).
* **ResilienceStats** — the ``rejected / shed / retried / quarantined /
  degraded_flushes`` counters threaded into ``CNNServer.stats()`` via
  ``api.Executable.attach_stats``.
* **HealthMonitor** — a healthy → degraded → draining state machine fed
  by per-flush wall latencies through the seed
  :class:`~repro_torch.runtime.straggler.StragglerMonitor` (median/MAD outlier
  detection).  Degraded serving falls back to smaller flush groups
  (smaller buckets); draining refuses new
  admissions until :meth:`HealthMonitor.resume`.
* **Chaos harness** — :class:`FaultPlan` (deterministic fault schedule,
  reusing :class:`~repro_torch.runtime.restart.FaultInjected`) +
  :class:`ChaosServer` (an ``infer`` proxy) inject fail-every-Nth-flush,
  permanent-poison (NaN image), latency-spike and shard-loss faults so
  every policy above is tested (tests/test_torch_serve.py, the ``chaos``
  pytest marker) and drilled on the card (``chip_smoke.py`` phase 10).

Everything here is single-threaded and clock-injectable like the queue
itself — chaos drills are bit-reproducible.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.runtime.restart import FaultInjected
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = [
    "ServeError",
    "AdmissionError",
    "DeadlineExceeded",
    "RequestPoisoned",
    "RetryPolicy",
    "ResilienceStats",
    "HEALTHY",
    "DEGRADED",
    "DRAINING",
    "HealthMonitor",
    "FaultPlan",
    "ChaosServer",
]


# ---------------------------------------------------------------------------
# Error taxonomy: the terminal states a ticket can resolve into.
# ---------------------------------------------------------------------------


class ServeError(RuntimeError):
    """Base of the serving-failure taxonomy.

    Every failed or shed ticket *resolves* with one of these as its
    ``Ticket.error`` — a ticket is never left dangling with
    ``result is None`` forever."""


class AdmissionError(ServeError):
    """Rejected at submit: queue at its admission bound, or draining."""


class DeadlineExceeded(ServeError):
    """Shed before execution: the ticket's deadline passed in the queue."""


class RequestPoisoned(ServeError):
    """Quarantined: the request kept failing *alone* after the bisecting
    isolation and the full retry budget (e.g. a NaN image or an
    OOM-sized request) — co-batched healthy tickets completed without
    it.  ``__cause__`` carries the last underlying exception."""


# ---------------------------------------------------------------------------
# Retry policy (transient faults).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff for transient faults.

    Applied by the queue only once a failing group is down to a single
    ticket (the bisecting quarantine isolates it first — retrying a
    whole batch would multiply the poison's flush cost past the
    O(log n) bound).  ``backoff(attempt)`` is ``backoff_s *
    backoff_mult ** attempt``; the queue sleeps through its injectable
    ``sleep`` so tests advance a fake clock instead of wall time."""

    max_retries: int = 2
    backoff_s: float = 0.001
    backoff_mult: float = 2.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0 or self.backoff_mult < 1.0:
            raise ValueError(
                f"backoff_s must be >= 0 and backoff_mult >= 1, got "
                f"{self.backoff_s}/{self.backoff_mult}")

    def backoff(self, attempt: int) -> float:
        """Seconds to wait before retry ``attempt`` (0-indexed)."""
        return self.backoff_s * self.backoff_mult ** attempt


# ---------------------------------------------------------------------------
# Counters (threaded into CNNServer.stats()).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResilienceStats:
    """Serving-resilience counters (DESIGN.md §3 failure-mode table).

    Lives on the server and is mutated by its queue, so
    ``server.stats()`` reports resilience next to the plan-cache
    counters."""

    rejected: int = 0          # submits refused by admission control
    shed: int = 0              # tickets expired (deadline): pre-flush
    #                            in the queue, or mid-retry backoff
    retried: int = 0           # single-ticket retry attempts (backoff)
    quarantined: int = 0       # tickets resolved as RequestPoisoned
    degraded_flushes: int = 0  # flush groups *actually executed* while
    #                            health was degraded (counted at infer
    #                            time, incl. bisection sub-flushes)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Health state machine.
# ---------------------------------------------------------------------------

HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"


class HealthMonitor:
    """healthy → degraded → draining over per-flush latencies + failures.

    Wraps the seed :class:`StragglerMonitor` (robust median/MAD window —
    resistant to the warmup flushes) on per-flush wall times:

    * a flagged (straggling) flush or a failed flush marks the server
      **degraded** — the queue then flushes in smaller groups
      (``degraded_max_batch``: smaller buckets), so a sick
      backend sees gentler batches before anyone is turned away;
    * ``drain_after`` *consecutive* unhealthy flushes escalate to
      **draining** — admissions are refused (:class:`AdmissionError`)
      while pending work completes; :meth:`resume` re-opens;
    * ``recover_after`` consecutive clean flushes de-escalate degraded
      back to healthy.
    """

    def __init__(
        self,
        monitor: Optional[StragglerMonitor] = None,
        *,
        drain_after: int = 4,
        recover_after: int = 3,
    ):
        if drain_after < 1 or recover_after < 1:
            raise ValueError(
                f"drain_after/recover_after must be >= 1, got "
                f"{drain_after}/{recover_after}")
        self.monitor = monitor if monitor is not None else StragglerMonitor(
            window=32, threshold=4.0, warmup=2)
        self.drain_after = drain_after
        self.recover_after = recover_after
        self.state = HEALTHY
        self._unhealthy_streak = 0
        self._clean_streak = 0
        self._flushes = 0

    @property
    def accepting(self) -> bool:
        """False once draining: refuse new admissions, finish pending."""
        return self.state != DRAINING

    @property
    def degraded(self) -> bool:
        """True in any non-healthy state (queue flushes smaller groups)."""
        return self.state != HEALTHY

    def _unhealthy(self):
        self._unhealthy_streak += 1
        self._clean_streak = 0
        if self.state == HEALTHY:
            self.state = DEGRADED
        if self.state == DEGRADED and self._unhealthy_streak >= \
                self.drain_after:
            self.state = DRAINING

    def record_flush(self, dt: float) -> str:
        """Feed one successful flush's wall latency; returns the state."""
        self._flushes += 1
        if self.monitor.record(self._flushes, dt):
            self._unhealthy()
        else:
            self._clean_streak += 1
            self._unhealthy_streak = 0
            if self.state == DEGRADED and self._clean_streak >= \
                    self.recover_after:
                self.state = HEALTHY
        return self.state

    def record_failure(self) -> str:
        """Feed one failed flush (an exception is an unhealthy sample,
        whatever its wall time); returns the state.

        Callers must record at most ONE failure per originating flush:
        the queue's bisecting quarantine turns a single fault event into
        O(log n) failing sub-flushes plus retries, and counting each of
        those as a consecutive unhealthy sample would let one poisoned
        request march the streak straight to draining (which only an
        operator ``resume()`` leaves)."""
        self._unhealthy()
        return self.state

    def resume(self) -> None:
        """Operator override: leave draining, reset streaks to healthy."""
        self.state = HEALTHY
        self._unhealthy_streak = 0
        self._clean_streak = 0


# ---------------------------------------------------------------------------
# Chaos harness: deterministic fault injection into server.infer.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault schedule for chaos drills.

    Applied by :class:`ChaosServer` before every ``infer`` call (the
    call counter makes every drill reproducible — no randomness):

    * ``fail_every=n``      — every nth call raises a *transient*
      :class:`~repro_torch.runtime.restart.FaultInjected` (recovers on retry
      because the counter has moved on).
    * ``poison_nan=True``   — any batch containing a NaN raises,
      permanently: the motivating poison request.  Isolation is the
      queue's bisecting quarantine's job.
    * ``latency_every=n``   — every nth call is delayed by
      ``latency_s`` (plus the always-on ``base_latency_s`` floor that
      gives the straggler window a baseline) through the injected
      ``delay`` callable — a fake clock's ``advance`` in tests.
    * ``shard_loss_after=k`` — from call ``k+1`` on, batches with more
      than ``shard_rows`` rows raise (a lost shard shrinks capacity);
      small/degraded batches still succeed, which is exactly the
      health machine's fallback path.

    ``injected`` counts each fault kind so tests and the chaos bench
    reconcile observed counters against injected faults.
    """

    fail_every: Optional[int] = None
    poison_nan: bool = False
    latency_every: Optional[int] = None
    latency_s: float = 0.05
    base_latency_s: float = 0.0
    shard_loss_after: Optional[int] = None
    shard_rows: int = 1
    calls: int = 0
    injected: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"transient": 0, "poison": 0,
                                 "latency": 0, "shard": 0})

    def __post_init__(self):
        for name in ("fail_every", "latency_every"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if self.shard_rows < 1:
            raise ValueError(f"shard_rows must be >= 1, got "
                             f"{self.shard_rows}")

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def apply(self, x: np.ndarray, delay: Callable[[float], None]) -> None:
        """Run the schedule for one infer call on batch ``x`` (may raise)."""
        self.calls += 1
        if self.base_latency_s:
            delay(self.base_latency_s)
        if self.latency_every and self.calls % self.latency_every == 0:
            self.injected["latency"] += 1
            delay(self.latency_s)
        if self.poison_nan and bool(np.isnan(x).any()):
            self.injected["poison"] += 1
            raise FaultInjected(
                f"poisoned request (NaN) in batch of {x.shape[0]} "
                f"(call {self.calls})")
        if (self.shard_loss_after is not None
                and self.calls > self.shard_loss_after
                and x.shape[0] > self.shard_rows):
            self.injected["shard"] += 1
            raise FaultInjected(
                f"shard lost after call {self.shard_loss_after}: batch of "
                f"{x.shape[0]} exceeds surviving capacity "
                f"{self.shard_rows} (call {self.calls})")
        if self.fail_every and self.calls % self.fail_every == 0:
            self.injected["transient"] += 1
            raise FaultInjected(
                f"injected transient fault (call {self.calls})")


class ChaosServer:
    """Proxy around a ``CNNServer`` injecting a :class:`FaultPlan` into
    ``infer``; everything else (``item_shape``, ``stats``,
    ``resilience``, ``exe``) delegates to the wrapped server, so a
    :class:`~repro_torch.launch.serve_cnn.MicroBatchQueue` cannot tell the
    difference.  ``delay`` realizes injected latency — ``time.sleep``
    live, a fake clock's ``advance`` in tests."""

    def __init__(self, server, plan: FaultPlan, *,
                 delay: Callable[[float], None] = time.sleep):
        self.server = server
        self.plan = plan
        self._delay = delay

    def __getattr__(self, name):
        return getattr(self.server, name)

    def infer(self, x):
        self.plan.apply(np.asarray(x), self._delay)
        return self.server.infer(x)
