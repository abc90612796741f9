"""Reads per controller step that served (admission controller)."""
from geobench import readings


def read(ctx):
    n = len(ctx["steps"])
    return readings.share(readings.window_reads(ctx), n)
