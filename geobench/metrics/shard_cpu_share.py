"""The shards' threads' CPU seconds over their wall seconds in ``shard.route`` spans: below 1, they waited for the interpreter lock or the device."""
from geobench import program_spans, readings


def read(ctx):
    recs = [r for r in program_spans.records(ctx, "shard.route") if "cpu_s" in r.tags]
    return readings.share(sum(r.tags["cpu_s"] for r in recs), sum(r.t1 - r.t0 for r in recs))
