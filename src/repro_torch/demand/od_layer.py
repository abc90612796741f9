"""Origin-destination demand layer: single owner of per-DC request heat.

One ``ODDemandLayer`` instance backs every :class:`~repro.core.placement.
HeatCache` of a store: ``heat[d]`` is DC *d*'s Alg. 3 eviction field (the
caches expose it as a shared-storage row view — accumulate, diffuse, decay,
evict all operate in place on this one table, nothing is double-booked).

On top of the raw field the layer keeps the windowed demand model the
control plane plans against:

  * ``od``       — monotone cumulative per-(origin, item) request weight
                   (never diffused or decayed: the ground truth a pre-stage
                   hit/wasted verdict is settled against);
  * ``rate``     — EWMA of per-window od rates (request weight / second);
  * ``profile``  — per-origin item mix (rows sum to 1 once an origin has
                   traffic): what the origin reads, independent of volume;
  * ``history``  — per-window origin intensity vectors, the series the
                   :class:`~repro.demand.Forecaster`s consume.

``measured()`` and ``forecast()`` return the same :class:`DemandView` shape
(item heat ``[I]`` + read-rate table ``[I, D]``), so migration planning and
pre-caching consume measured and predicted demand through one code path.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DemandView", "ODDemandLayer"]


@dataclasses.dataclass
class DemandView:
    """One demand snapshot in planner coordinates.

    ``horizon == 0`` means measured (current EWMA rates); ``horizon >= 1``
    means a forecast that many windows ahead.  ``read_rates`` aligns with the
    ``r_xy`` table :func:`~repro.streaming.migration.plan_migrations` takes,
    ``item_heat`` with its ``item_heat`` ranking input.
    """

    intensity: np.ndarray  # [D] per-origin request weight per second
    item_heat: np.ndarray  # [I] aggregate per-item demand
    read_rates: np.ndarray  # [I, D] per-(item, origin) demand rates
    horizon: int = 0

    @property
    def total(self) -> float:
        return float(self.intensity.sum())


class ODDemandLayer:
    """Accumulates per-(origin DC, item) request heat from the serving path.

    ``observe``/``observe_requests`` are the only write entry points for
    online heat — stores and caches delegate here, which is what makes the
    single-ownership invariant checkable (``tests/test_demand.py``).
    Windowing is driven by the caller's clock (simulated or wall) through
    ``advance_to(now)``; with no clock the layer degenerates to one open
    window and the raw heat field still behaves exactly like the legacy
    per-DC arrays.
    """

    def __init__(
        self,
        n_items: int,
        n_dcs: int,
        window_s: float = 60.0,
        t0: float = 0.0,
        max_windows: int = 512,
        rate_alpha: float = 0.35,
        profile_alpha: float = 0.35,
        rate_floor: float = 0.0,
        registry=None,
    ) -> None:
        if n_dcs < 1:
            raise ValueError(f"need at least one DC, got {n_dcs}")
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.n_items = int(n_items)
        self.n_dcs = int(n_dcs)
        self.window_s = float(window_s)
        self.rate_alpha = float(rate_alpha)
        self.profile_alpha = float(profile_alpha)
        # sparsification: a pure EWMA never reaches exactly zero, so a
        # replica once read would look "serving" forever and could never be
        # dropped by planners keying on ``rate > 0``.  Entries below
        # ``rate_floor`` x the table max are clamped to zero at window close
        # (0.0 = off, exact EWMA semantics).
        self.rate_floor = float(rate_floor)
        self._registry = registry
        # the one [D, I] online heat table (C-contiguous so heat[d] is a
        # contiguous row view the HeatCaches mutate in place)
        self.heat = np.zeros((self.n_dcs, self.n_items), dtype=np.float32)
        # monotone cumulative od weight + its snapshot at the open window's
        # start (current-window mass = od - _od_win_start, one copy/window)
        self.od = np.zeros((self.n_dcs, self.n_items), dtype=np.float32)
        self._od_win_start = self.od.copy()
        self.rate = np.zeros((self.n_dcs, self.n_items), dtype=np.float32)
        self.profile = np.zeros((self.n_dcs, self.n_items), dtype=np.float32)
        self.window_index = 0
        self._win_t0 = float(t0)
        self.history: Deque[np.ndarray] = deque(maxlen=int(max_windows))
        # window_index -> predicted intensity, settled when that window closes
        self._pending_forecasts: Dict[int, np.ndarray] = {}
        self.last_forecast_abs_err: Optional[np.ndarray] = None
        self.total_observed = 0.0

    # ------------------------------------------------------------- telemetry
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from ..obs import get_registry

        return get_registry()

    # ------------------------------------------------------------ observation
    def observe(self, item_ids: np.ndarray, origin: int = 0, freq: float = 1.0) -> None:
        """Deposit one access-event batch from ``origin`` (Alg. 3 lines 3-5).

        Duplicate ids accumulate (``np.add.at``), matching the legacy
        per-cache scatter exactly — fancy-index ``+=`` would collapse them.
        A weight that float32 holds exactly (the serving path's 1.0) goes in
        as a float32 scalar, the tables' dtype: a Python float sends
        ``np.add.at`` down its casting loop, some thirty times slower, which
        adds in float64 and rounds each sum to float32 once, the same sum a
        float32 add gives.  Any other weight keeps that loop.
        """
        ids = np.asarray(item_ids)
        w = np.float32(freq)
        if float(w) != freq:
            w = freq
        np.add.at(self.heat[origin], ids, w)
        np.add.at(self.od[origin], ids, w)
        self.total_observed += float(freq) * len(ids)

    def observe_requests(self, requests: Sequence[Tuple[np.ndarray, int]]) -> None:
        """Deposit a served batch: ``(items, origin)`` pairs, grouped so each
        touched DC pays one scatter (the ``serve_batch`` hot path)."""
        by_origin: Dict[int, List[np.ndarray]] = {}
        for items, o in requests:
            by_origin.setdefault(int(o), []).append(items)
        for o, groups in by_origin.items():
            self.observe(np.concatenate(groups), origin=o)

    # -------------------------------------------------------------- windowing
    def advance_to(self, now: float) -> int:
        """Close every demand window that ended at or before ``now``; returns
        the number closed.  Idle stretches close as empty (zero-intensity)
        windows — real signal for the forecasters, but bulk-skipped past the
        first so a huge clock jump costs O(history), not O(elapsed/window)."""
        if not math.isfinite(now):
            return 0
        n_due = int((now - self._win_t0) // self.window_s)
        if n_due <= 0:
            return 0
        self._close_window()  # the one window that may carry data
        skip = n_due - 1
        if skip > 0:
            # the remaining windows are provably empty (observe() cannot have
            # run between clock reads): decay the rate model once, record a
            # bounded number of zero-intensity windows for the forecasters
            self.rate *= (1.0 - self.rate_alpha) ** skip
            zeros = np.zeros(self.n_dcs, dtype=np.float64)
            for _ in range(min(skip, self.history.maxlen or skip)):
                self.history.append(zeros.copy())
            self.window_index += skip
            self._win_t0 += skip * self.window_s
            self._pending_forecasts = {
                k: v for k, v in self._pending_forecasts.items()
                if k >= self.window_index
            }
        return n_due

    def _close_window(self) -> None:
        win = self.od - self._od_win_start  # [D, I] mass of the closing window
        inv_w = 1.0 / self.window_s
        intensity = (win.sum(axis=1) * inv_w).astype(np.float64)
        a = self.rate_alpha
        self.rate *= 1.0 - a
        self.rate += (a * inv_w) * win
        if self.rate_floor > 0.0:
            m = float(self.rate.max())
            if m > 0.0:
                self.rate[self.rate < self.rate_floor * m] = 0.0
        mass = win.sum(axis=1)
        pa = self.profile_alpha
        for d in np.where(mass > 0)[0]:
            self.profile[d] *= 1.0 - pa
            self.profile[d] += (pa / mass[d]) * win[d]
        self.history.append(intensity)
        hat = self._pending_forecasts.pop(self.window_index, None)
        if hat is not None:
            err = np.abs(hat - intensity)
            self.last_forecast_abs_err = err
            reg = self._reg()
            if reg.enabled:
                for d in range(self.n_dcs):
                    reg.gauge("demand.forecast_abs_err", origin=d).set(float(err[d]))
                reg.histogram("demand.forecast_mae").observe(float(err.mean()))
        reg = self._reg()
        if reg.enabled:
            reg.counter("demand.windows").inc()
            reg.gauge("demand.intensity").set(float(intensity.sum()))
        self._od_win_start = self.od.copy()
        self.window_index += 1
        self._win_t0 += self.window_s

    # ------------------------------------------------------------------ views
    def measured(self) -> DemandView:
        """The EWMA-rate demand view (what a reactive planner should chase)."""
        rates = np.ascontiguousarray(self.rate.T)
        return DemandView(
            intensity=self.rate.sum(axis=1).astype(np.float64),
            item_heat=self.rate.sum(axis=0).astype(np.float64),
            read_rates=rates,
            horizon=0,
        )

    def forecast(self, forecaster, horizon: int = 1) -> DemandView:
        """Predict demand ``horizon`` windows ahead.

        Per-origin intensity comes from the forecaster over this layer's
        history; it is spread over items through each origin's learned
        profile, so the view has the same planner coordinates as
        :meth:`measured`.  The prediction is recorded and settled against the
        realized intensity when the target window closes (forecast-error
        gauges)."""
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        D = self.n_dcs
        if self.history:
            series = np.stack(self.history)  # [W, D]
        else:
            series = np.zeros((0, D), dtype=np.float64)
        hat = np.array(
            [
                max(0.0, float(forecaster.forecast(series[:, d], horizon)))
                for d in range(D)
            ],
            dtype=np.float64,
        )
        rates_od = self.profile.astype(np.float64) * hat[:, None]  # [D, I]
        self._pending_forecasts[self.window_index + int(horizon) - 1] = hat
        return DemandView(
            intensity=hat,
            item_heat=rates_od.sum(axis=0),
            read_rates=np.ascontiguousarray(rates_od.T),
            horizon=int(horizon),
        )

    def apply_diffusion(
        self, row: int, vertex_heat: np.ndarray, tail_decay: float
    ) -> None:
        """Write one DC's diffused heat field back into the owned table.

        The DHD step (``step_heat_caches``) reads heat *views*, diffuses the
        vertex block and decays the edge tail — but the ``[D, I]`` table is
        single-owned here, so the result comes back through this method
        rather than through a write to the ``HeatCache.heat`` view (the
        exactly-once-deposit invariant geolint GL003 enforces)."""
        n = len(vertex_heat)
        self.heat[row, :n] = vertex_heat
        self.heat[row, n:] *= tail_decay

    # ----------------------------------------------------- id-space remapping
    def grow_items(self, old_n_nodes: int, n_new_vertices: int, n_new_edges: int) -> None:
        """Grow every item-indexed table for a mutation batch, preserving the
        ``vertex v -> v, edge e -> n_nodes + e`` layout (the one shared
        encoding in :func:`repro.core.graph.grow_item_rows`).  HeatCache row
        views re-read through the property, so they follow automatically."""
        from ..core.graph import grow_item_rows

        def grow(a: np.ndarray) -> np.ndarray:
            return np.stack(
                [grow_item_rows(row, old_n_nodes, n_new_vertices, n_new_edges, 0.0)
                 for row in a]
            )

        self.heat = grow(self.heat)
        self.od = grow(self.od)
        self._od_win_start = grow(self._od_win_start)
        self.rate = grow(self.rate)
        self.profile = grow(self.profile)
        self.n_items = self.heat.shape[1]

    def take_rows(self, keep: np.ndarray) -> None:
        """Row-select every item-indexed table onto a compacted id space."""
        keep = np.asarray(keep)
        self.heat = np.ascontiguousarray(self.heat[:, keep])
        self.od = np.ascontiguousarray(self.od[:, keep])
        self._od_win_start = np.ascontiguousarray(self._od_win_start[:, keep])
        self.rate = np.ascontiguousarray(self.rate[:, keep])
        self.profile = np.ascontiguousarray(self.profile[:, keep])
        self.n_items = self.heat.shape[1]

    # ------------------------------------------------------------------ stats
    def stats(self) -> Dict[str, object]:
        return {
            "n_items": self.n_items,
            "n_dcs": self.n_dcs,
            "window_s": self.window_s,
            "window_index": self.window_index,
            "windows_recorded": len(self.history),
            "total_observed": self.total_observed,
            "pending_forecasts": len(self._pending_forecasts),
        }
