"""The wall clock the admission controller runs on inside a benchmark run.

``now()`` is ``perf_counter`` seconds since the clock was made.  A drain's
time has already passed when the controller calls ``advance()``, so that
does nothing.  ``jump_to(t)`` waits until ``t`` on the wall clock, but never
past ``horizon``: the harness sets that to the window's end, so the
controller can never sleep through it.
"""
from __future__ import annotations

import math
import time

__all__ = ["WallClock", "wait_until"]


def wait_until(clock_now, t: float) -> None:
    """Block until ``clock_now() >= t``: sleep while more than 2 ms remain,
    then spin, since a sleep overshoots by tens of microseconds."""
    while True:
        left = t - clock_now()
        if left <= 0.0:
            return
        if left > 2e-3:
            time.sleep(left - 1e-3)


class WallClock:
    def __init__(self) -> None:
        self.origin = time.perf_counter()
        self.horizon = math.inf

    def now(self) -> float:
        return time.perf_counter() - self.origin

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (dt={dt})")

    def jump_to(self, t: float) -> None:
        wait_until(self.now, min(float(t), self.horizon))
