"""Shards' busy seconds summed over the facade's serve_batch wall seconds."""
from geobench import readings


def read(ctx):
    walls = readings.probe_in_window(ctx)
    return readings.share(sum(s for _, s in walls), sum(w for w, _ in walls))
