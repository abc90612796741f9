"""Share of routed read items whose ``route.expand`` took the fused path (the kernel on the card) and not the numpy or scalar router."""
from geobench import program_spans, readings


def read(ctx):
    recs = program_spans.records(ctx, "route.expand")
    if any("items" not in r.tags for r in recs):
        return None
    fused = sum(r.tags["items"] for r in recs if r.tags.get("path") == "fused")
    return readings.share(fused, sum(r.tags["items"] for r in recs))
