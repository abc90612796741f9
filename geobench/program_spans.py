"""Readings of the program's own spans, beside ``readings``: the records
with their tags, and microseconds a read."""
from __future__ import annotations

from typing import Optional

from geobench import readings

__all__ = ["records", "us_per_read"]


def records(ctx, name: str) -> list:
    """The store tracer's ``name`` spans that began in the window, as
    ``readings.spans`` counts them."""
    tracer = ctx["tracer"]
    if tracer is None:
        return []
    a, b = readings._abs_window(ctx)
    return [r for r in tracer.records if r.name == name and a <= r.t0 < b]


def us_per_read(ctx, name: str) -> Optional[float]:
    """Microseconds of ``name`` spans a window read; ``None`` where the
    program records no such span."""
    durs = readings.spans(ctx, name)
    return readings.share(sum(durs) * 1e6, readings.window_reads(ctx)) if durs else None
