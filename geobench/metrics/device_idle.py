"""Per cent of the profiled sub-window in which no device operation ran."""
from geobench import readings


def read(ctx):
    return readings.idle(ctx)
