"""Microseconds a read of the facade's payload gather: upload, gather, sum, synchronise (``facade.fetch_rows`` spans)."""
from geobench import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "facade.fetch_rows")
