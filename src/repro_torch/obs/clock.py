"""Host clocks of the port (the reference's ``repro.obs.clock``).

Everything in the port reads host time through a ``Clock``, the one module
allowed to read the host clock directly, so a test can substitute a
deterministic source.  Timestamps are microseconds.
"""
from __future__ import annotations

import time


class Clock:
    """Minimal clock protocol: ``now_us()`` returns microseconds."""

    def now_us(self) -> float:
        raise NotImplementedError


class MonotonicClock(Clock):
    """Wall clock backed by ``time.perf_counter`` (monotonic, sub-us)."""

    def __init__(self):
        self._origin = time.perf_counter()

    def now_us(self) -> float:
        return (time.perf_counter() - self._origin) * 1e6
