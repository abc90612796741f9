"""Demand plane: the single owner of online request heat.

Only :class:`ODDemandLayer` is ported so far; the forecasters of
``repro.demand.forecast`` come with a later slice."""
from .od_layer import DemandView, ODDemandLayer  # noqa: F401

__all__ = ["DemandView", "ODDemandLayer"]
