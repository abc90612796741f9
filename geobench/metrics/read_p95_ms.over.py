"""The 95th percentile read time of an over-capacity cell, in ms: where the queue grows all through the run, so it swings."""
from geobench import stats


def read(ctx):
    return stats.p95(ctx["lat"]) * 1e3
