"""Shared arithmetic of the per-layer readers in ``metrics/``."""
from __future__ import annotations

from typing import List, Optional

__all__ = ["window_reads", "spans", "probe_in_window", "share", "idle"]


def _abs_window(ctx) -> tuple:
    return ctx["clock_origin"] + ctx["T0"], ctx["clock_origin"] + ctx["end"]


def window_reads(ctx) -> int:
    """Reads served by the window's drains."""
    return sum(n for _, _, n, _ in ctx["steps"])


def spans(ctx, name: str) -> List[float]:
    """Durations of the store tracer's ``name`` spans that began in the
    window."""
    tracer = ctx["tracer"]
    if tracer is None:
        return []
    a, b = _abs_window(ctx)
    return [r.t1 - r.t0 for r in tracer.records if r.name == name and a <= r.t0 < b]


def probe_in_window(ctx) -> list:
    """``(wall seconds, shard seconds summed)`` of each ``serve_batch`` the
    window's drains made, timed by the harness around the call."""
    a, b = _abs_window(ctx)
    return [(t1 - t0, s) for t0, t1, s in ctx["probe"] if a <= t0 < b]


def share(num: float, den: float) -> Optional[float]:
    return num / den if den > 0 else None


def idle(ctx) -> Optional[float]:
    dev = ctx.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
