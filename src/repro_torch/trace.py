"""Spans inside the program, on the profiler's clock.

::

    from repro_torch import trace

    with trace.recording():           # or inside any torch.profiler session
        logits = exe(images)
    torch.cuda.synchronize()
    for s in trace.spans("plan.forward"):
        s.name, s.root, s.host_ms, s.counts["images"], s.device_ms

While nothing records, a span site costs one check: :func:`span` returns
a shared no-op, with no ``record_function``, no CUDA event and no span
object.  Recording is on inside a :func:`recording` block, or while a
``torch.profiler`` session is active, so a profile taken of a deployment
holds the program's spans with no other change.

A :class:`Span` keeps its name, its id, its parent's id and the id of its
outermost span (``root``: one request's spans share it), its start and end
on ``time.time_ns()``, the clock the profiler's host and device events
carry, and its counts.  With ``device=`` a CUDA device it also records a
pair of timing CUDA events on that device's current stream around the
span; their elapsed time is read when ``device_ms`` is, after the caller
has synchronized.  On the CPU ``device_ms`` is ``None``, never a host time.

The newest :data:`CAPACITY` spans stay in memory (:func:`dropped` counts
the older ones let go); :func:`spans` reads them without draining, so
several readers read the same spans.  Nothing is written to disk.

The program's spans (each read by a metric of ``BENCHMARK.json``):

* ``plan.forward`` — one call of a compiled CNN plan (``images``: the
  bucket's rows);
* ``plan.occupancy`` — the plane-occupancy prepass of one conv or linear
  layer of a plan;
* ``lm.prefill`` — one ``LMExecutable.prefill`` (``tokens``: batch x
  bucket positions computed; ``true_tokens``: prompts x prompt length);
* ``lm.attention`` / ``lm.ffn`` — one layer's attention / FFN block
  (the MoE shared experts' FFN too), device-timed; ``lm.ffn`` counts
  ``fused``, the block's radix products that took the fused path
  (``lm/radix.PRODUCTS``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, Optional

import torch

__all__ = ["CAPACITY", "Span", "span", "recording", "spans", "dropped",
           "clear"]

CAPACITY = 1 << 20
"""How many of the newest spans are kept."""

_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_lock = threading.Lock()
_kept = 0                       # spans closed since the last clear()
_recording = 0                  # open recording() blocks
_ids = itertools.count(1)
_local = threading.local()      # this thread's stack of open spans
_profiling = torch._C._autograd._profiler_enabled


class Span:
    """One closed (or open) span; times in ``time.time_ns()`` ns."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "counts", "_events", "_device_ms")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts
        self.parent = None
        self.start_ns = self.end_ns = 0
        self._events = None
        self._device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Device milliseconds between the span's CUDA events (waits for
        the second), or ``None`` where the span was not device-timed."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    __slots__ = ("span", "stream")

    def __init__(self, name: str, device, counts: dict):
        self.span = Span(name, counts)
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None and device.type == "cuda"
                       else None)

    def __enter__(self) -> Span:
        s = self.span
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        s.id = next(_ids)
        if stack:
            s.parent, s.root = stack[-1].id, stack[0].id
        else:
            s.root = s.id
        stack.append(s)
        if self.stream is not None:
            s._events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            s._events[0].record(self.stream)
        s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc):
        global _kept
        s = self.span
        s.end_ns = time.time_ns()
        if self.stream is not None:
            s._events[1].record(self.stream)
        _local.stack.pop()
        with _lock:
            _buffer.append(s)
            _kept += 1
        return False


def span(name: str, *, device=None, **counts):
    """A context manager around one piece of the program's work, recorded
    only while :func:`recording` or a ``torch.profiler`` session is on.
    ``device``: the ``torch.device`` whose current stream the span times
    with CUDA events (only a CUDA device is timed); ``counts``: numbers
    the span carries."""
    if not (_recording or _profiling()):
        return _NOOP
    return _Open(name, device, counts)


@contextlib.contextmanager
def recording():
    """Record spans inside this block (blocks nest)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans(name: Optional[str] = None) -> List[Span]:
    """The kept spans named ``name`` (all when None), oldest first.
    Reading does not remove them."""
    with _lock:
        got = list(_buffer)
    return got if name is None else [s for s in got if s.name == name]


def dropped() -> int:
    """Spans closed since the last :func:`clear` that are no longer kept."""
    with _lock:
        return _kept - len(_buffer)


def clear() -> None:
    """Forget every kept span."""
    global _kept
    with _lock:
        _buffer.clear()
        _kept = 0
