"""Microseconds a read of routing on the shards' threads, summed over shards (``shard.route`` spans)."""
from geobench import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "shard.route")
