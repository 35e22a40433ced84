"""The traced window: ``torch.profiler`` over the window, read from its raw
kineto events (``key_averages`` first builds every host event's tree,
which takes most of a long trace's reading time).

The harness's own spans (``bench.<name>``, ``record_function`` around
each call into a layer of the program) label what the host was doing
while the device sat idle.  Profiler events stay in memory; only the
summary leaves the process."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"


def short(name: str, width: int = 96) -> str:
    """A kernel's name without ``void`` and cut to ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width]


@dataclasses.dataclass
class TraceView:
    """What a per-layer metric reads: the device events inside the window
    as (name, start_us, duration_us), the window's and the busy seconds,
    the harness's spans as (name, start_us, end_us), and the counts of
    the work the cell ran (``info``, from its module under ``drivers/``)."""

    kernels: List[Tuple[str, float, float]]
    window_s: float
    busy_s: float
    spans: List[Tuple[str, float, float]]
    info: dict
    config: dict
    workload: dict

    def kernel(self, part: str) -> Tuple[float, int]:
        """(seconds, launches) of the device events whose name holds
        ``part``."""
        hits = [d for n, _, d in self.kernels if part in n]
        return sum(hits) / 1e6, len(hits)


class Tracer:
    """``with tracer.window():`` traces the window when ``on``; ``span``
    labels a call into the program (a no-op when tracing is off)."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None
        self.kernels: List[Tuple[str, float, float]] = []
        self.spans: List[Tuple[str, float, float]] = []
        self.window_us: Optional[Tuple[float, float]] = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        with self._prof:
            with torch.profiler.record_function(WINDOW):
                yield
        self._read()

    def _read(self) -> None:
        for e in self._prof.profiler.kineto_results.events():
            dev = str(e.device_type())
            start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
            if dev.endswith("CUDA"):
                if not e.is_user_annotation() and dur > 0:
                    self.kernels.append((e.name(), start, dur))
            elif e.is_user_annotation() and e.name().startswith("bench."):
                if e.name() == WINDOW:
                    self.window_us = (start, start + dur)
                else:
                    self.spans.append((e.name()[6:], start, start + dur))
        self._prof = None
        if self.window_us is None:
            raise RuntimeError("the profiler recorded no window span")
        w0, w1 = self.window_us
        self.kernels = [k for k in self.kernels
                        if k[1] < w1 and k[1] + k[2] > w0]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals inside the window."""
        w0, w1 = self.window_us
        out: List[List[float]] = []
        for _, s, d in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, w0), min(s + d, w1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def view(self, info: dict, config: dict, workload: dict) -> TraceView:
        w0, w1 = self.window_us
        busy = sum(e - s for s, e in self.busy()) / 1e6
        return TraceView(self.kernels, (w1 - w0) / 1e6, busy, self.spans,
                         info, config, workload)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time
        of the device by what the host was doing (the innermost harness
        span over the gap's middle, else ``host``)."""
        ops: Dict[str, float] = {}
        for n, _, d in self.kernels:
            ops[short(n)] = ops.get(short(n), 0.0) + d / 1e6
        w0, w1 = self.window_us
        edges = [w0] + [t for iv in self.busy() for t in iv] + [w1]
        gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
        # one sweep over span starts, gap middles and span ends in time
        # order; the spans nest, so the innermost open one is the last
        points = sorted([(sp[1], 0, i) for i, sp in enumerate(self.spans)]
                        + [((s + e) / 2, 1, i) for i, (s, e) in
                           enumerate(gaps)]
                        + [(sp[2], 2, i) for i, sp in enumerate(self.spans)])
        idle: Dict[str, float] = {}
        open_spans: List[int] = []
        for _, kind, i in points:
            if kind == 0:
                open_spans.append(i)
            elif kind == 2:
                open_spans.remove(i)
            else:
                label = self.spans[open_spans[-1]][0] if open_spans \
                    else "host"
                idle[label] = idle.get(label, 0.0) + (gaps[i][1]
                                                      - gaps[i][0]) / 1e6
        rank = lambda d: sorted(([k, v] for k, v in d.items()),
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
