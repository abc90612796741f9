"""Microseconds a read of the sharded facade's serve_batch, timed around the call."""
from geobench import readings


def read(ctx):
    walls = readings.probe_in_window(ctx)
    if not walls:
        return None
    return readings.share(sum(w for w, _ in walls) * 1e6, readings.window_reads(ctx))
