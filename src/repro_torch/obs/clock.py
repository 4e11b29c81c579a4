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


class ManualClock(Clock):
    """Deterministic clock: advances ``tick_us`` on every read.

    Two runs that make the same sequence of ``now_us()`` calls observe
    identical timestamps, which makes trace and journal output
    byte-for-byte reproducible regardless of host speed.
    """

    def __init__(self, start_us: float = 0.0, tick_us: float = 1.0):
        self._now = float(start_us)
        self.tick_us = float(tick_us)

    def now_us(self) -> float:
        t = self._now
        self._now += self.tick_us
        return t

    def advance(self, us: float) -> None:
        self._now += float(us)
