"""Microseconds a read the sharded facade waits for its shards' sub-batches (``facade.pool_wait`` spans)."""
from geobench import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "facade.pool_wait")
