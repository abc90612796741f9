"""Bytes a ragged route-expansion launch must move, and its share of the
card's HBM roofline.

A launch must read each item slot's replica bitmask and size (4 B each) and
write its pick (1 B), and for each read its offset, origin and place in the
launch order, and write its layers used, its missing count after each
layer, its bytes per DC, its straggler latency and its WAN bytes (4 B
each).  The share divides those bytes by the launches' device time in the
profiled sub-window and by the card's HBM bandwidth.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["HBM_BYTES_PER_S", "KERNEL", "ragged_bytes", "route_expand_share"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
KERNEL = "route_expand_ragged_kernel"  # the device events it times


def ragged_bytes(slots: int, reads: int, n_dcs: int, n_layers: int) -> int:
    """Bytes one launch over ``slots`` items of ``reads`` reads must move."""
    per_read = 4 * (3 + 1 + (n_layers + 1) + n_dcs + 2)
    return 9 * slots + reads * per_read + 4  # + the offsets' closing entry


def route_expand_share(ctx) -> Optional[float]:
    """Per cent of the roofline of the ragged launches the program's
    ``route.device`` spans (tag ``variant`` ``"ragged"``) made in the
    profiled sub-window; ``None`` where it made none."""
    from geobench.tracing import _events

    prof, tracer = ctx.get("prof"), ctx.get("tracer")
    if prof is None or tracer is None or not prof.stopped:
        return None
    recs = [r for r in tracer.records if r.name == "route.device"
            and r.tags.get("variant") == "ragged" and prof.t_start <= r.t0 < prof.t_stop]
    ns = sum(e.duration_ns() for e in _events(prof) if KERNEL in e.name())
    if not recs or ns <= 0:
        return None
    d = int(ctx["cell"].config["n_dcs"])
    moved = sum(ragged_bytes(r.tags["slots"], r.tags["reads"], d, r.tags["layers"])
                for r in recs)
    return 100.0 * moved / (ns * 1e-9) / HBM_BYTES_PER_S
