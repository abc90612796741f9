"""Budgeted background maintenance interleaved into serving idle gaps.

The third leg of the control plane: the :class:`AdmissionController` owns
the clock and offers every idle gap (router quiescent, next arrival in the
future) to a :class:`MaintenancePolicy`, which spends it on background work
in priority order:

  1. **Migration transfer waves** — an in-flight flush
     (``store.begin_flush`` → :class:`~repro_torch.streaming.migration.WaveApplier`)
     lands one :class:`~repro_torch.streaming.migration.TransferWave` at a time;
     serving between waves always sees a placement-consistent route table
     (the invariant of the wave-by-wave flush, now scheduled instead of
     inline).
  2. **Delta compaction** — proactive ``store.compact()`` below the store's
     reactive tombstone trigger, charged at ``compact_cost_s``.
  3. **Heat maintenance** — periodic ``store.maintain()`` (Alg. 3 diffusion
     + eviction + residual paydown), charged at ``maintain_cost_s``.

**Closing the window loop**: every applied wave
reports a *measured* transfer time (via the ``measure_wave`` hook; defaults
to the Eq. 1 estimate when no measurement exists).  The policy tracks the
EWMA of ``estimated / measured`` in :attr:`window_gain` and plans the next
flush with ``effective_window() = window_s * window_gain`` — links that ship
slower than Table I says shrink the byte budget per wave until estimates and
measurements agree, links that ship faster widen it.

**Predictive mode** (``predictive=True``): every time the store's demand
plane closes a window, the policy forecasts per-origin demand one window
ahead (:class:`~repro_torch.demand.Forecaster` over the
:class:`~repro_torch.demand.ODDemandLayer` history) and *pre-stages* replicas
against the forecast heat through the same ``begin_flush`` → wave machinery
— adds only (``theta_drop=0``), landed in idle gaps before the demand
arrives, epoch guards unchanged.  Each pre-staged replica is held in a
ledger and settled one window later against the demand plane's cumulative
od table: ``placement.prestage_hit`` if the destination DC actually read it,
``placement.prestage_wasted`` otherwise.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Deque, Dict, Optional, Tuple

import numpy as np

from ..streaming.migration import StaleFlushError

__all__ = ["MaintenanceConfig", "MaintenancePolicy"]


@dataclasses.dataclass
class MaintenanceConfig:
    window_s: float = 60.0  # target transfer window (pre-correction)
    budget_frac: Optional[float] = None  # WAN byte budget (None = store default)
    flush_every_s: Optional[float] = None  # periodic flush cadence (None = explicit)
    maintain_every_s: Optional[float] = None  # periodic maintain cadence
    maintain_cost_s: float = 0.050  # simulated cost of one maintain()
    compact_cost_s: float = 0.250  # simulated cost of one compact()
    compact_ratio: float = 0.15  # proactive threshold (< store's reactive 0.30)
    diffusion_steps: int = 4
    packing: str = "ff"  # wave packing ("ff" | "lpt")
    ewma_alpha: float = 0.5  # weight of the newest estimate/measured ratio
    min_window_gain: float = 0.05
    max_window_gain: float = 4.0
    plan_kw: Dict[str, object] = dataclasses.field(default_factory=dict)
    # ---- demand-plane planning ------------------------------------------
    # "store": periodic flushes plan against the store's warm-DHD
    # equilibrium over the static workload (the legacy reactive source).
    # "measured": they plan against the demand plane's measured EWMA view —
    # reacting to the traffic actually served.
    heat_source: str = "store"
    # ---- predictive pre-staging -----------------------------------------
    predictive: bool = False  # forecast-driven pre-stage flushes
    forecaster: Optional[object] = None  # demand.Forecaster (default: EWMA)
    prestage_horizon: int = 1  # demand windows ahead to forecast
    prestage_budget_frac: Optional[float] = None  # None = budget_frac/store default
    prestage_theta_add: float = 0.5  # add quantile for pre-stage plans


class MaintenancePolicy:
    """Spends idle gaps on migration waves, compaction and heat maintenance.

    ``measure_wave(wave) -> seconds`` injects the observed transfer time of
    an applied wave (a real deployment times the bulk RPC; tests and
    benchmarks model degraded links).  Liveness: if the next wave cannot fit
    even the offered gap, one wave is applied anyway — a flush never stalls
    forever behind short gaps (the controller clamps the clock advance to
    the gap, so serving is not pushed back by the overrun).
    """

    def __init__(
        self,
        store,
        config: Optional[MaintenanceConfig] = None,
        measure_wave: Optional[Callable[[object], float]] = None,
        tracer=None,
        registry=None,
    ) -> None:
        self.store = store
        self.cfg = config or MaintenanceConfig()
        self.measure_wave = measure_wave
        # an AdmissionController adopting this policy shares its sim-clock
        # tracer (so wave spans land on the serving timeline); standalone
        # users may inject their own
        self.tracer = tracer
        self._registry = registry
        self.window_gain = 1.0  # EWMA of estimated / measured wave makespan
        # ring-buffered like the controller's telemetry: the policy is
        # long-lived and periodic flushes would grow these without bound
        self.wave_log: Deque[Tuple[float, float]] = deque(maxlen=4096)
        self._applier = None
        self._flush_requested = False
        self._flush_kw: Dict[str, object] = {}
        self._last_flush: Optional[float] = None
        self._last_maintain: Optional[float] = None
        self.plans: Deque[object] = deque(maxlen=64)  # most recent flush plans
        self.n_flushes = 0
        self.n_waves = 0
        self.n_maintains = 0
        self.n_compactions = 0
        self.n_stale_flushes = 0  # appliers abandoned to an id-space change
        self.last_maintain_report: Optional[Dict[str, float]] = None
        # predictive pre-staging state
        self.forecaster = self.cfg.forecaster
        if self.cfg.predictive and self.forecaster is None:
            from ..demand import EWMAForecaster

            self.forecaster = EWMAForecaster()
        self._applier_prestage = False  # current applier is a pre-stage flush
        self._last_prestage_window = -1
        # planner-scaled (item_heat, read_rates) of the newest forecast,
        # folded into measured flushes so they don't undo fresh pre-stages
        self._last_forecast: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # (id epoch, demand window, dst DC, items, od snapshot) per landed
        # pre-stage transfer; settled one full demand window later
        self._prestage_ledger: Deque[Tuple] = deque(maxlen=4096)
        self.n_prestage_flushes = 0
        self.prestage_hits = 0
        self.prestage_wasted = 0

    # ------------------------------------------------------------- triggers
    def request_flush(self, **plan_kw) -> None:
        """Arm a migration flush; it begins in the next idle gap."""
        self._flush_requested = True
        self._flush_kw = dict(plan_kw)

    @property
    def flush_in_progress(self) -> bool:
        return self._applier is not None

    def effective_window(self) -> float:
        """Measurement-corrected transfer window for the *next* schedule."""
        return self.cfg.window_s * self.window_gain

    def _reg(self):
        from ..obs import get_registry

        return self._registry if self._registry is not None else get_registry()

    def _trace_wave(self, t0: float, wave, measured_s: float) -> None:
        """Span + per-link byte telemetry for one applied transfer wave.

        ``t0`` is the simulated start (the idle-gap cursor), so wave spans
        interleave correctly with the controller's request spans when both
        share the sim-clock tracer."""
        tr = self.tracer
        traced = tr is not None and tr.enabled
        reg = self._reg()
        if not traced and not reg.enabled:
            return
        env = self.store.env
        t1 = t0 + measured_s
        root = None
        if traced:
            root = tr.record(
                "migration_wave", t0, t1, track="maintenance",
                wave=wave.index, nbytes=int(wave.nbytes),
                n_links=len(wave.links),
                est_makespan_s=round(wave.makespan_s, 6),
            )
        if reg.enabled:
            # one grid update per wave — the per-link loop must not pay a
            # string-keyed instrument lookup per link (GL004); grid cells
            # export per-(src,dst) exactly like the old tagged counters
            mat = np.zeros((env.n_dcs, env.n_dcs))
            for b in wave.links:
                mat[b.src, b.dst] += b.nbytes
            reg.counter_grid("migration.wan_bytes", axes=("src", "dst")).add(mat)
        if traced:
            for b in wave.links:
                est = b.nbytes / env.bw_Bps[b.src, b.dst] + env.rtt_s[b.src, b.dst]
                tr.record(
                    "link_transfer", t0, min(t0 + est, t1), track="maintenance",
                    parent=root, src=b.src, dst=b.dst, nbytes=int(b.nbytes),
                )
        if reg.enabled:
            reg.histogram("migration.wave_makespan_s").observe(measured_s)
            reg.gauge("maintenance.window_gain").set(self.window_gain)

    def _record_wave(self, estimated_s: float, measured_s: float) -> None:
        self.wave_log.append((float(estimated_s), float(measured_s)))
        if estimated_s > 0 and measured_s > 0:
            ratio = estimated_s / measured_s
            a = self.cfg.ewma_alpha
            self.window_gain = min(
                self.cfg.max_window_gain,
                max(self.cfg.min_window_gain,
                    (1.0 - a) * self.window_gain + a * ratio),
            )

    def _flush_due(self, now: float) -> bool:
        if self._applier is not None:
            return False
        if self._flush_requested:
            return True
        if self.cfg.flush_every_s is None:
            return False
        return self._last_flush is None or now - self._last_flush >= self.cfg.flush_every_s

    def _maintain_due(self, now: float) -> bool:
        if self.cfg.maintain_every_s is None:
            return False
        return (
            self._last_maintain is None
            or now - self._last_maintain >= self.cfg.maintain_every_s
        )

    # ------------------------------------------------------------ idle hook
    def on_idle(self, now: float, gap_s: float, quiescent: bool = True) -> float:
        """Fill up to ``gap_s`` seconds of router idle time; returns the
        simulated seconds actually consumed.

        ``quiescent=False`` withholds **compaction**: compacting renumbers
        item rows, which would invalidate raw item arrays held outside the
        store.  The controller passes True only when it is subscribed to the
        store's remap hook (its in-flight handles re-key automatically);
        callers without such protection pass False while requests are
        outstanding.  Waves and ``maintain()`` only change replica sets,
        never item ids, so they run regardless."""
        used = 0.0
        demand = getattr(self.store, "demand", None)
        if demand is not None:
            demand.advance_to(now)
            if self._prestage_ledger:
                self._settle_prestaged(demand)
        if self._flush_due(now):
            budget = (
                None if self.cfg.budget_frac is None
                else self.cfg.budget_frac * float(self.store.g.item_size().sum())
            )
            kw = dict(self.cfg.plan_kw)
            kw.update(self._flush_kw)
            if self.cfg.heat_source == "measured" and demand is not None:
                # plan against the traffic actually served (demand plane).
                # In predictive mode, fold the latest forecast in elementwise
                # (max): dropping a replica the policy *just* pre-staged for
                # the next window, because the measured view hasn't seen its
                # demand yet, would be incoherent.
                heat, rates = self._planner_scale(demand.measured())
                if self._last_forecast is not None:
                    f_heat, f_rates = self._last_forecast
                    if f_heat.shape == heat.shape:
                        heat = np.maximum(heat, f_heat)
                        rates = np.maximum(rates, f_rates)
                kw.setdefault("item_heat", heat)
                kw.setdefault("read_rates", rates)
            plan, self._applier = self.store.begin_flush(
                budget_bytes=budget,
                window_s=self.effective_window(),
                schedule=self.cfg.packing,
                **kw,
            )
            self._applier_prestage = False
            self.plans.append(plan)
            self._flush_requested = False
            self._flush_kw = {}
            self._last_flush = now
            self.n_flushes += 1
        elif (
            self._applier is None
            and self.cfg.predictive
            and demand is not None
            and len(demand.history)
            and demand.window_index > self._last_prestage_window
        ):
            # pre-stage flush: plan adds against *forecast* demand one window
            # ahead; waves land through the shared idle-gap loop below with
            # the epoch guards unchanged.  Never drops — the forecast earns
            # replicas, evicting on it is the measured paths' job.
            self._last_prestage_window = demand.window_index
            view = demand.forecast(
                self.forecaster, horizon=self.cfg.prestage_horizon
            )
            frac = (
                self.cfg.prestage_budget_frac
                if self.cfg.prestage_budget_frac is not None
                else self.cfg.budget_frac
            )
            budget = (
                None if frac is None
                else frac * float(self.store.g.item_size().sum())
            )
            heat, rates = self._planner_scale(view)
            self._last_forecast = (heat, rates)
            kw = dict(self.cfg.plan_kw)
            kw["item_heat"] = heat
            kw["read_rates"] = rates
            kw.setdefault("theta_add", self.cfg.prestage_theta_add)
            kw["theta_drop"] = 0.0
            plan, self._applier = self.store.begin_flush(
                budget_bytes=budget,
                window_s=self.effective_window(),
                schedule=self.cfg.packing,
                **kw,
            )
            self._applier_prestage = True
            self.plans.append(plan)
            self.n_prestage_flushes += 1
            if plan.schedule is not None:
                self._ledger_moves(demand, plan.schedule.local)
        # 1. land transfer waves while they fit (always at least one: a wave
        # wider than every gap must not stall the flush forever).  A
        # StaleFlushError (mutation/compaction renumbered ids mid-flight)
        # abandons the applier — already-landed adds are safe, drops never
        # released — and re-arms the flush for a fresh plan next gap.
        while self._applier is not None:
            wave = self._applier.peek()
            try:
                if wave is None:
                    self._applier.finish()  # drops release + constraint guard
                    self._applier = None
                    self._applier_prestage = False
                    break
                expected = wave.makespan_s / max(self.window_gain, 1e-9)
                if used + expected > gap_s and not (used == 0.0 and expected > gap_s):
                    break
                wave = self._applier.apply_next()
            except StaleFlushError:
                self._applier = None
                self.n_stale_flushes += 1
                if not self._applier_prestage:
                    self._flush_requested = True  # re-plan against the new ids
                self._applier_prestage = False
                break
            if self._applier_prestage and demand is not None:
                self._ledger_wave(demand, wave)
            measured = (
                self.measure_wave(wave) if self.measure_wave is not None
                else wave.makespan_s
            )
            self._record_wave(wave.makespan_s, measured)
            self._trace_wave(now + used, wave, measured)
            self.n_waves += 1
            used += measured
            if used >= gap_s:
                break
        if self._applier is not None:
            return used  # gap exhausted mid-flush; waves resume next gap
        # 2. proactive delta compaction (only with no requests in flight)
        if (
            quiescent
            and self.store.tombstone_ratio() >= self.cfg.compact_ratio
            and used + self.cfg.compact_cost_s <= gap_s
        ):
            if self.store.compact():
                self.n_compactions += 1
                self._trace_simple("compact", now + used, self.cfg.compact_cost_s)
                used += self.cfg.compact_cost_s
        # 3. periodic heat maintenance (diffusion + eviction + residual)
        if self._maintain_due(now) and used + self.cfg.maintain_cost_s <= gap_s:
            self.last_maintain_report = self.store.maintain(
                diffusion_steps=self.cfg.diffusion_steps
            )
            self._last_maintain = now
            self.n_maintains += 1
            self._trace_simple("maintain", now + used, self.cfg.maintain_cost_s)
            used += self.cfg.maintain_cost_s
        return used

    def _planner_scale(self, view) -> Tuple[np.ndarray, np.ndarray]:
        """Rescale a demand view to the workload's planner units.

        The demand plane reports true per-second rates; the migration
        planner's cost model (Eq. 14) was calibrated against the offline
        workload's ``r_xy``/``w_xy`` magnitudes, so per-second rates next to
        workload-scale write costs would price every add out.  Treating the
        view as a *redistribution* of the workload's total read volume keeps
        the read/write economics consistent.  An all-zero view passes
        through untouched (the zero-forecast differential relies on it
        producing an empty plan)."""
        wl = getattr(self.store, "workload", None)
        total = float(view.read_rates.sum())
        if wl is None or total <= 0.0:
            return view.item_heat, view.read_rates
        scale = float(wl.r_xy.sum()) / total
        return view.item_heat * scale, view.read_rates * scale

    # ------------------------------------------------------- prestage ledger
    def _ledger_wave(self, demand, wave) -> None:
        """Record one landed pre-stage wave: per destination DC, the shipped
        items and the demand plane's cumulative od weight at landing time."""
        epoch = getattr(self.store, "_id_epoch", 0)
        for b in wave.links:
            items = np.asarray(b.items)
            self._prestage_ledger.append((
                epoch, demand.window_index, int(b.dst), items.copy(),
                demand.od[b.dst, items].copy(),
            ))

    def _ledger_moves(self, demand, moves) -> None:
        """Record zero-byte local pre-stage adds (src == dst moves)."""
        if not moves:
            return
        epoch = getattr(self.store, "_id_epoch", 0)
        by_dc: Dict[int, list] = {}
        for m in moves:
            by_dc.setdefault(int(m.dc), []).append(int(m.item))
        for dc, its in by_dc.items():
            items = np.asarray(its, dtype=np.int64)
            self._prestage_ledger.append((
                epoch, demand.window_index, dc, items,
                demand.od[dc, items].copy(),
            ))

    def _settle_prestaged(self, demand) -> None:
        """Settle ledger entries at least one full demand window old: a
        pre-staged replica *hit* if its destination DC accumulated new od
        weight on the item since landing (the monotone od table is immune to
        diffusion/decay), else it was *wasted* WAN + storage.  Entries from a
        renumbered id space are unverifiable and dropped silently."""
        epoch = getattr(self.store, "_id_epoch", 0)
        reg = self._reg()
        keep: Deque[Tuple] = deque(maxlen=self._prestage_ledger.maxlen)
        hit_total = wasted_total = 0
        for entry in self._prestage_ledger:
            e_epoch, e_win, dc, items, od0 = entry
            if e_epoch != epoch:
                continue
            if demand.window_index <= e_win:
                keep.append(entry)  # target window still open
                continue
            hits = int((demand.od[dc, items] > od0).sum())
            wasted = int(len(items) - hits)
            self.prestage_hits += hits
            self.prestage_wasted += wasted
            hit_total += hits
            wasted_total += wasted
        # settle the counters once per drain, not per ledger entry (GL004)
        if reg.enabled:
            if hit_total:
                reg.counter("placement.prestage_hit").inc(hit_total)
            if wasted_total:
                reg.counter("placement.prestage_wasted").inc(wasted_total)
        self._prestage_ledger = keep

    def _trace_simple(self, name: str, t0: float, cost_s: float) -> None:
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.record(name, t0, t0 + cost_s, track="maintenance")

    def drain(self, now: float = 0.0) -> float:
        """Run all armed/outstanding maintenance to completion (unbounded
        gap) — the synchronous escape hatch for tests and shutdown paths."""
        return self.on_idle(now, math.inf)

    def stats(self) -> Dict[str, object]:
        return {
            "n_flushes": self.n_flushes,
            "n_waves": self.n_waves,
            "n_maintains": self.n_maintains,
            "n_compactions": self.n_compactions,
            "n_stale_flushes": self.n_stale_flushes,
            "window_gain": self.window_gain,
            "effective_window_s": self.effective_window(),
            "flush_in_progress": self.flush_in_progress,
            "n_prestage_flushes": self.n_prestage_flushes,
            "prestage_hits": self.prestage_hits,
            "prestage_wasted": self.prestage_wasted,
        }
