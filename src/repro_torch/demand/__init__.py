"""Demand plane: the single owner of online request heat and its forecasts.

:class:`ODDemandLayer` owns the one ``[D, n_items]`` heat table the serving
path deposits into and every per-DC ``HeatCache`` reads as a view; its
windowed origin-destination statistics feed the measured demand view, and a
pluggable :class:`Forecaster` (persistence, EWMA, seasonal) predicts each
origin's intensity one window ahead for the forecast view."""
from .forecast import (  # noqa: F401
    EWMAForecaster,
    Forecaster,
    PersistenceForecaster,
    SeasonalForecaster,
    ZeroForecaster,
)
from .od_layer import DemandView, ODDemandLayer  # noqa: F401

__all__ = [
    "ODDemandLayer",
    "DemandView",
    "Forecaster",
    "EWMAForecaster",
    "SeasonalForecaster",
    "PersistenceForecaster",
    "ZeroForecaster",
]
