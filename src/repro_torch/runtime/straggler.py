"""Straggler detection + mitigation policy (port of ``repro/runtime/straggler.py``).

At pod scale a slow host stalls every collective.  The monitor keeps a
robust running profile of step times (median / MAD — resistant to the
compile-time first step) and flags outliers; ``MitigationPolicy`` decides
between the standard responses, in escalating order:

  observe   -> keep counting (transient noise)
  rebalance -> shrink the straggler's share (e.g. route fewer microbatches
               through its pipeline stage)
  evict     -> checkpoint, drop the host, resume on N-1 (with hot-spare
               promotion when a spare is registered)

On a single-process container the timings are per-step wall times and the
mitigation is simulated; the decision logic and its tests are exactly what
a real multi-host deployment runs against per-host heartbeat timings.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, List, Optional, Tuple

__all__ = ["StragglerMonitor", "MitigationPolicy"]


class StragglerMonitor:
    """Robust step-time outlier detector (median + MAD window)."""

    def __init__(self, window: int = 50, threshold: float = 4.0,
                 warmup: int = 2):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.threshold = threshold
        self.warmup = warmup
        self._seen = 0
        self.outliers: List[Tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler (after warmup)."""
        self._seen += 1
        if self._seen <= self.warmup:        # first steps include compile
            return False
        flagged = self.is_outlier(dt)
        if flagged:
            self.outliers.append((step, dt))
        self.window.append(dt)
        return flagged

    @staticmethod
    def _median(xs: List[float]) -> float:
        """True median of a sorted list (even n: mean of the middle two
        — the upper-element shortcut biases the outlier threshold high)."""
        n = len(xs)
        mid = n // 2
        return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])

    def _stats(self) -> Tuple[float, float]:
        if not self.window:
            return 0.0, 0.0
        xs = sorted(self.window)
        med = self._median(xs)
        mad = self._median(sorted(abs(x - med) for x in xs))
        return med, mad

    def is_outlier(self, dt: float) -> bool:
        med, mad = self._stats()
        if med == 0.0:
            return False
        return dt > med + self.threshold * max(mad, 0.05 * med)


@dataclasses.dataclass
class MitigationPolicy:
    """Escalating response to repeated stragglers from the same host."""

    rebalance_after: int = 3
    evict_after: int = 8
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    spares: List[str] = dataclasses.field(default_factory=list)

    def register_spare(self, host: str):
        self.spares.append(host)

    def report(self, host: str) -> str:
        """Record one straggler event; returns the action to take."""
        c = self.counts.get(host, 0) + 1
        self.counts[host] = c
        if c >= self.evict_after:
            return "evict+promote" if self.spares else "evict"
        if c >= self.rebalance_after:
            return "rebalance"
        return "observe"

    def recovered(self, host: str):
        self.counts.pop(host, None)

    def evict(self, host: str) -> Optional[str]:
        """Returns the promoted spare (or None -> shrink to N-1)."""
        self.counts.pop(host, None)
        return self.spares.pop(0) if self.spares else None
