"""Fault type shared by the chaos harness (port of the part of
``repro/runtime/restart.py`` that serving needs).

``RestartableRun``, the checkpointing training loop, waits for the
training slice of the port (ROADMAP.md, queue 1 item 6).
"""

from __future__ import annotations

__all__ = ["FaultInjected"]


class FaultInjected(RuntimeError):
    """Injected failure for tests / chaos drills."""
