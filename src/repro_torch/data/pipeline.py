"""Sharded, prefetching input pipeline (port of ``repro/data/pipeline.py``).

``ShardedLoader`` turns a deterministic batch function (step -> numpy
arrays) into DTensor batches laid out over a device mesh: each rank
keeps only its piece of every array (cut from the host array here, no
communication), so the global batch is never on one device.

``Prefetcher`` overlaps host-side batch synthesis with device compute: a
background thread fills a depth-bounded queue from a step-indexed loader,
so the next batch is staged while the current one computes.  Loaders are
step-indexed, so a run resumed from a checkpoint at step k replays batch
k + 1 with no pipeline state.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ShardedLoader", "Prefetcher"]

BatchFn = Callable[[int], Tuple[np.ndarray, ...]]


class ShardedLoader:
    """step -> tuple of DTensors on ``mesh``, one per array of
    ``batch_fn(step)``, placed by ``specs`` (one spec each, typically the
    batch dim over the data axes; ``parallel.sharding.batch_specs``)."""

    def __init__(self, batch_fn: BatchFn, mesh, specs: Sequence[tuple]):
        self._fn = batch_fn
        self._mesh = mesh
        self._specs = [tuple(s) for s in specs]
        from repro_torch.parallel.sharding import mesh_device

        self._device = mesh_device(mesh)

    def __call__(self, step: int):
        from torch.distributed.tensor import DTensor

        from repro_torch.parallel.sharding import local_slice, placements

        out = []
        for arr, spec in zip(self._fn(step), self._specs):
            piece = np.ascontiguousarray(local_slice(np.asarray(arr), spec,
                                                     self._mesh))
            out.append(DTensor.from_local(
                torch.from_numpy(piece).to(self._device), self._mesh,
                placements(spec, self._mesh), run_check=False))
        return tuple(out)


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
