"""The program's own spans (``repro_torch.trace``) inside the traced
window, for the per-layer metrics that read them.

The window runs from the earliest harness span's start to the latest
one's end (``TraceView.spans``, on the profiler's clock, which the
program's spans share: ``time.time_ns()``).  A program without the
module, or a window without harness spans, gives ``None``: the reader
is then silent."""

from __future__ import annotations

from typing import List, Optional


def inside(t, name: str) -> Optional[list]:
    """The program's spans named ``name`` whose start lies in the traced
    window, oldest first; ``None`` where the program keeps no spans."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    if not t.spans:
        return None
    w0 = min(s[1] for s in t.spans) * 1e3
    w1 = max(s[2] for s in t.spans) * 1e3
    return [s for s in trace.spans(name) if w0 <= s.start_ns <= w1]


def per_call(t, name: str, calls: int, each: int = 1) -> Optional[List]:
    """``inside(t, name)`` when it holds ``each`` spans for each of
    ``calls`` calls, else ``None``."""
    got = inside(t, name)
    if not got or not calls or len(got) != calls * each:
        return None
    return got


def device_ms_per_call(t, name: str) -> Optional[float]:
    """Device milliseconds a prefill call of the ``name`` spans (one a
    layer a call); ``None`` where a span has no device time (the CPU)."""
    calls = len(t.info.get("lengths", []))
    got = per_call(t, name, calls, int(t.config["n_layers"]))
    if got is None:
        return None
    ms = [s.device_ms for s in got]
    if any(m is None for m in ms):
        return None
    return sum(ms) / calls
