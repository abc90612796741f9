"""Microseconds a read of the demand plane's per-origin observe (``facade.observe`` spans)."""
from geobench import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "facade.observe")
