"""Failure and restart runner (port of ``repro/runtime/restart.py``): run
a step function under a crash contract.

``RestartableRun`` wraps a training loop with the recovery protocol:

  1. an async checkpoint every ``ckpt_every`` steps (an atomic rename: a
     crash mid-write never corrupts the newest complete checkpoint);
  2. on failure (process death, an injected fault), the relaunched run
     finds ``latest_step``, restores, and replays the data pipeline from
     that step index (step-indexed loaders make this determinate);
  3. at-most-once side effects: the step counter lives in the saved
     state, so a replayed step overwrites rather than double-applies.

A run with a fault at any step, then resumed, ends in a state equal to
an uninterrupted run's (``tests/test_torch_train_runtime.py``; on the
card, ``chip_smoke.py`` phase 16 with cuDNN's deterministic algorithms).
``FaultInjected`` is also the chaos harness's fault type.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.train import checkpoint as ckpt_lib

__all__ = ["RestartableRun", "FaultInjected"]


class FaultInjected(RuntimeError):
    """Injected failure for tests / chaos drills."""


@dataclasses.dataclass
class RestartableRun:
    """step_fn(state, batch) -> (state, metrics); batch_fn(step) -> batch."""

    step_fn: Callable
    batch_fn: Callable[[int], Any]
    ckpt_dir: str
    ckpt_every: int = 10
    keep: int = 3

    def run(self, state, *, steps: int,
            fault_at: Optional[int] = None,
            on_metrics: Optional[Callable[[int, Any], None]] = None):
        """Run to ``steps`` total, resuming from the newest checkpoint."""
        manager = ckpt_lib.CheckpointManager(self.ckpt_dir, keep=self.keep)
        start = 0
        last = ckpt_lib.latest_step(self.ckpt_dir)
        if last is not None:
            state, _ = ckpt_lib.restore(self.ckpt_dir, last, state)
            start = last
        metrics = None
        for s in range(start, steps):
            if fault_at is not None and s == fault_at:
                manager.wait()
                raise FaultInjected(f"injected at step {s}")
            state, metrics = self.step_fn(state, self.batch_fn(s))
            if on_metrics:
                on_metrics(s, metrics)
            if (s + 1) % self.ckpt_every == 0:
                manager.save(s + 1, state)
        manager.save(steps, state)
        manager.wait()
        return state, metrics
