"""Prefetching input pipeline (port of ``repro/data/pipeline.py``,
``Prefetcher``).

``Prefetcher`` overlaps host-side batch synthesis with device compute: a
background thread fills a depth-bounded queue from a step-indexed loader,
so the next batch is staged while the current one computes.  Loaders are
step-indexed, so a run resumed from a checkpoint at step k replays batch
k + 1 with no pipeline state.  ``ShardedLoader``, which lays a batch out
over a device mesh, waits for multi-GPU (ROADMAP.md, queue 1 item 7).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

__all__ = ["Prefetcher"]


class Prefetcher:
    """Depth-bounded background prefetch over a step-indexed loader:
    yields ``(step, loader(step))`` for ``num_steps`` steps from
    ``start_step``; a loader error is raised by the next ``__next__``."""

    def __init__(self, loader: Callable[[int], object], start_step: int,
                 num_steps: int, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for s in range(start_step, start_step + num_steps):
                    self._q.put((s, loader(s)))
            except BaseException as e:  # surfaced on the next __next__
                self._err = e
            finally:
                self._q.put(None)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
