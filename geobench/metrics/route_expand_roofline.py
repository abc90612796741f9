"""Per cent of the HBM roofline of the ragged route-expansion launches in the profiled sub-window: the bytes they must move (``geobench/roofline.py``) over their device time, over 3.35 TB/s."""
from geobench import roofline


def read(ctx):
    return roofline.route_expand_share(ctx)
