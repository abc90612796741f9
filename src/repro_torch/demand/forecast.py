"""Pluggable per-origin intensity forecasters for the demand plane.

A forecaster maps one origin DC's *intensity history* — the per-window
request-weight rates recorded by :class:`~repro_torch.demand.ODDemandLayer` — to a
predicted intensity ``horizon`` windows ahead.  Forecasters are stateless
over the series (the layer owns the history), so one instance serves every
origin and re-forecasting after a resume is deterministic.

``SeasonalForecaster`` is the follow-the-sun workhorse: diurnal demand is a
level times a repeating phase shape, so it decomposes the series into an
EWMA level and multiplicative per-phase seasonal indices and recomposes at
the target phase — it anticipates a handoff the EWMA level alone can only
lag behind.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "Forecaster",
    "ZeroForecaster",
    "PersistenceForecaster",
    "EWMAForecaster",
    "SeasonalForecaster",
]

_EPS = 1e-12


class Forecaster:
    """Interface: predict one origin's intensity ``horizon`` windows ahead.

    ``series`` is the chronological per-window intensity history of a single
    origin (``[W]`` floats, oldest first; possibly empty).  Implementations
    must be pure functions of ``(series, horizon)``.
    """

    name = "base"

    def forecast(self, series: np.ndarray, horizon: int = 1) -> float:
        raise NotImplementedError


class ZeroForecaster(Forecaster):
    """Predicts zero demand everywhere — the null forecast.

    A predictive policy driven by this forecaster plans empty pre-stage
    move-sets, so it must be replica-set- and route-identical to the
    reactive policy (the behavior-preservation differential in
    the demand tests)."""

    name = "zero"

    def forecast(self, series: np.ndarray, horizon: int = 1) -> float:
        return 0.0


class PersistenceForecaster(Forecaster):
    """Identity / persistence forecast: tomorrow looks like the last window."""

    name = "persistence"

    def forecast(self, series: np.ndarray, horizon: int = 1) -> float:
        return float(series[-1]) if len(series) else 0.0


class EWMAForecaster(Forecaster):
    """Exponentially-weighted level; horizon-independent (flat) forecast."""

    name = "ewma"

    def __init__(self, alpha: float = 0.4) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)

    def forecast(self, series: np.ndarray, horizon: int = 1) -> float:
        if not len(series):
            return 0.0
        level = float(series[0])
        for x in series[1:]:
            level = (1.0 - self.alpha) * level + self.alpha * float(x)
        return max(0.0, level)


class SeasonalForecaster(Forecaster):
    """Multiplicative diurnal decomposition: EWMA level x per-phase index.

    ``period`` is the cycle length in demand windows (e.g. 8 windows per
    simulated day).  Each observation updates the level and the seasonal
    index of its phase bin; the forecast recomposes ``level * season[phase]``
    at the target phase — so a demand peak that visits the same phase every
    cycle is predicted *before* it arrives, which is exactly what pre-staging
    needs during follow-the-sun handoffs.
    """

    name = "seasonal"

    def __init__(
        self, period: int, alpha: float = 0.3, season_alpha: float = 0.5
    ) -> None:
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        self.period = int(period)
        self.alpha = float(alpha)
        self.season_alpha = float(season_alpha)

    def forecast(self, series: np.ndarray, horizon: int = 1) -> float:
        W = len(series)
        if W == 0:
            return 0.0
        level = max(float(series[0]), _EPS)
        season = np.ones(self.period, dtype=np.float64)
        sa = self.season_alpha
        for t in range(W):
            x = float(series[t])
            if t > 0:
                level = (1.0 - self.alpha) * level + self.alpha * x
            ph = t % self.period
            season[ph] = (1.0 - sa) * season[ph] + sa * (x / max(level, _EPS))
        phase = (W + int(horizon) - 1) % self.period
        return max(0.0, level * float(season[phase]))
