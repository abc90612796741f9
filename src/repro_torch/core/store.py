"""GeoGraphStore — the public facade of the GeoLayer system.

Ties together: layered-graph construction (§IV), overlap-centric replica
placement (§V), stepwise routing (§VI), cost accounting (§III) and the
maintenance strategy (§V "Update Maintenance"): heat-based eviction and
demand-driven pre-caching.

The device work — the DHD diffusions of placement, pre-caching and
maintenance, and the fused routing expansion of ``serve_batch`` — runs on
``device`` (``None`` = the card, ``"cpu"`` = the plain versions on the
host).  This port carries ``placement="geolayer"`` with
``routing="stepwise"``: build, serving, maintenance, pre-caching and
costing.  The baseline strategies, the workload and streaming updates and
offline planning raise :class:`NotImplementedError` naming the ROADMAP
slice that brings them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..demand import ODDemandLayer
from ..device import DeviceLike, resolve_device
from ..obs import Tracer, get_registry
from .cost import CostBreakdown, PlacementState, check_constraints, total_cost
from .graph import Graph
from .latency import GeoEnvironment
from .layered_graph import LayeredGraph, build_layered_graph
from .patterns import Pattern, Workload
from .placement import (
    HeatCache,
    PlacementConfig,
    overlap_centric_placement,
    precache_hot_regions,
    step_heat_caches,
)
from .route_index import RouteIndex
from .routing import RouteResult, route_online, route_online_batch

__all__ = ["GeoGraphStore", "StoreStats"]

_BASELINES_SLICE = "ROADMAP queue 1, slice A item 6 (core/baselines.py)"
_STREAMING_SLICE = "ROADMAP queue 1, slice B (streaming updates)"
_OFFLINE_SLICE = "ROADMAP queue 1, slice D (offline analytics)"


@dataclasses.dataclass
class StoreStats:
    placement_stats: Dict[str, object]
    build_time_s: float
    placement_time_s: float


class GeoGraphStore:
    """Geo-distributed graph store with GeoLayer placement + routing.

    The data-plane kernel of the system: placement state, routing tables,
    heat fields and their maintenance primitives (``serve_batch`` /
    ``maintain`` / ``precache``).

    ``state`` adopts an existing placement instead of running one (see
    :func:`repro_torch.convert.store_from_numpy`): the layered graph, route
    index, demand plane and heat caches are built as usual around it.
    """

    def __init__(
        self,
        g: Graph,
        env: GeoEnvironment,
        workload: Workload,
        config: Optional[PlacementConfig] = None,
        placement: str = "geolayer",
        routing: str = "stepwise",
        latency_interval_s: float = 0.100,
        seed: int = 0,
        tracer: Optional[Tracer] = None,
        registry=None,
        demand_window_s: float = 60.0,
        device: DeviceLike = None,
        state: Optional[PlacementState] = None,
    ) -> None:
        if placement != "geolayer":
            raise NotImplementedError(
                f"placement={placement!r} is not ported yet: {_BASELINES_SLICE}"
            )
        if routing != "stepwise":
            raise NotImplementedError(
                f"routing={routing!r} is not ported yet: {_BASELINES_SLICE}"
            )
        self.g = g
        self.env = env
        self.workload = workload
        self.config = config or PlacementConfig()
        self.placement_name = placement
        self.routing_name = routing
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else Tracer(clock=time.perf_counter)
        self._registry = registry
        # wall-clock seconds of the last serve_batch routing pass
        self.last_serve_seconds = 0.0
        self.route_index: Optional[RouteIndex] = None
        with self.tracer.span("store.build_layered_graph", track="store") as sp_build:
            self.lg: LayeredGraph = build_layered_graph(
                g, env, latency_interval_s=latency_interval_s
            )
        with self.tracer.span("store.place", track="store", strategy=placement) as sp_place:
            if state is None:
                self.state, pstats = self._place()
            else:
                self.state, pstats = state, {"adopted": True}
        with self.tracer.span("store.route", track="store", strategy=routing):
            self._apply_routing()
        # demand plane: single owner of online request heat; every per-DC
        # HeatCache reads its row of the [D, I] table as a view
        self.demand = ODDemandLayer(
            g.n_items, env.n_dcs, window_s=demand_window_s, registry=registry
        )
        self.caches = {
            d: HeatCache(
                g, d, self.state, self.config.dhd, demand=self.demand,
                device=self.device,
            )
            for d in range(env.n_dcs)
        }
        self.stats = StoreStats(
            placement_stats=pstats,
            build_time_s=sp_build.elapsed_s(),
            placement_time_s=sp_place.elapsed_s(),
        )

    # ------------------------------------------------------------- telemetry
    def _reg(self):
        """Explicit registry if one was injected, else the process default."""
        return self._registry if self._registry is not None else get_registry()

    # ------------------------------------------------------------ strategies
    def _place(self) -> Tuple[PlacementState, Dict]:
        return overlap_centric_placement(
            self.lg, self.workload, self.config, device=self.device
        )

    def _apply_routing(self) -> None:
        # per-item nearest-replica table; pattern requests use route_online.
        # ``state.route`` aliases ``index.nearest`` so incremental patches
        # are visible to every consumer without copies.
        self.route_index = RouteIndex.build(self.state.delta, self.env)
        self.state.route = self.route_index.nearest

    # -------------------------------------------------------------- serving
    def serve_online(self, pattern: Pattern, origin: int) -> RouteResult:
        """Serve one online pattern request; returns the routing outcome."""
        res = route_online(self.lg, self.state, pattern.items, origin)
        # record the access into the demand plane (Alg. 3 injection)
        self.demand.observe(pattern.items, origin=origin, freq=1.0)
        return res

    def serve_batch(
        self,
        requests: Sequence[Tuple[object, int]],
        observe: bool = True,
    ) -> List[RouteResult]:
        """Serve a whole batch of online requests in one vectorized pass.

        ``requests`` is a sequence of ``(pattern_or_items, origin)`` pairs;
        results align with the input order and match ``serve_online``
        request-for-request.  The batch resolves through
        :func:`route_online_batch` on the store's device, where the size
        gates pick the fused expansion.
        """
        norm: List[Tuple[np.ndarray, int]] = []
        for req, origin in requests:
            items = req.items if isinstance(req, Pattern) else np.asarray(req)
            norm.append((items, int(origin)))
        t_serve = time.perf_counter()
        with self.tracer.span("store.serve_batch", track="store", size=len(norm)):
            results = route_online_batch(
                self.lg, self.state, norm, registry=self._registry,
                device=self.device,
            )
        self.last_serve_seconds = time.perf_counter() - t_serve
        if observe and norm:
            # heat injection grouped per origin inside the demand plane
            self.demand.observe_requests(norm)
        return results

    # ---------------------------------------------------------- maintenance
    def _resync_route_index(self) -> None:
        """Re-adopt the routing table if external code orphaned the alias
        (a full ``state.route_nearest(env)`` replaces ``state.route``)."""
        if self.state.route is not self.route_index.nearest:
            self.route_index.rebuild(self.state.delta)
            self.state.route = self.route_index.nearest

    def maintain(self, evict: bool = True, diffusion_steps: int = 4) -> Dict[str, float]:
        """Periodic maintenance: heat diffusion + cold-replica eviction
        (Alg. 3) and a routing refresh of the rows whose replica sets
        shrank.  ``heat_residual`` is 0: the warm streaming DHD field comes
        with slice B."""
        with self.tracer.span("store.maintain", track="store"):
            self._resync_route_index()
            evicted = 0
            # all per-DC caches share one topology -> ONE batched diffusion
            step_heat_caches(list(self.caches.values()), n_steps=diffusion_steps)
            for dc, cache in self.caches.items():
                if evict:
                    ids = cache.evict()
                    evicted += len(ids)
                    self.route_index.drop_replicas(self.state.delta, ids, dc)
            return {"evicted": evicted, "heat_residual": 0.0}

    def demand_view(self):
        """Measured demand-plane view (:class:`~repro_torch.demand.DemandView`)."""
        return self.demand.measured()

    def precache(
        self,
        item_heat: Optional[np.ndarray] = None,
        theta_quantile: Optional[float] = None,
        max_per_dc: Optional[int] = None,
    ) -> np.ndarray:
        """Demand-driven DHD pre-caching (§V), online flavor.

        Seeds :func:`~repro_torch.core.placement.precache_hot_regions` from
        the demand plane: an injected ``item_heat`` if given, else the
        measured demand view, else — before any traffic — the static
        workload tables.  Newly added replicas are patched into the route
        index; returns the item rows whose replica sets changed."""
        self._resync_route_index()
        intensity = item_heat
        if intensity is None:
            measured = self.demand.measured().item_heat
            if float(measured.max(initial=0.0)) > 0.0:
                intensity = measured
        before = self.state.delta.copy()
        precache_hot_regions(
            self.g, self.workload, self.state,
            self.config.theta_quantile if theta_quantile is None else theta_quantile,
            self.config.dhd,
            max_per_dc=(
                self.config.precache_max_per_dc if max_per_dc is None else max_per_dc
            ),
            read_intensity=intensity,
            device=self.device,
        )
        changed = np.where((self.state.delta != before).any(axis=1))[0]
        if len(changed):
            self.route_index.patch_rows(self.state.delta, changed)
        return changed

    # ---------------------------------------------------- streaming updates
    def insert_patterns(self, new_patterns):
        raise NotImplementedError(f"insert_patterns is not ported yet: {_STREAMING_SLICE}")

    def insert_patterns_incremental(self, new_patterns):
        raise NotImplementedError(
            f"insert_patterns_incremental is not ported yet: {_STREAMING_SLICE}"
        )

    def delete_items(self, item_ids):
        raise NotImplementedError(f"delete_items is not ported yet: {_STREAMING_SLICE}")

    def plan_offline(self, *args, **kw):
        raise NotImplementedError(f"plan_offline is not ported yet: {_OFFLINE_SLICE}")

    def apply_updates(self, batch):
        raise NotImplementedError(f"apply_updates is not ported yet: {_STREAMING_SLICE}")

    def compact(self) -> bool:
        raise NotImplementedError(f"compact is not ported yet: {_STREAMING_SLICE}")

    def plan_flush(self, *args, **kw):
        raise NotImplementedError(f"plan_flush is not ported yet: {_STREAMING_SLICE}")

    def begin_flush(self, *args, **kw):
        raise NotImplementedError(f"begin_flush is not ported yet: {_STREAMING_SLICE}")

    def flush_migrations(self, *args, **kw):
        raise NotImplementedError(
            f"flush_migrations is not ported yet: {_STREAMING_SLICE}"
        )

    # -------------------------------------------------------------- costing
    def cost(self) -> CostBreakdown:
        return total_cost(
            self.workload.patterns,
            self.state,
            self.workload.r_xy,
            self.workload.w_xy,
            self.g.item_size(),
            self.env,
            self.config.lambda1,
            self.config.lambda2,
        )

    def constraints(self, gamma_max_s: Optional[float] = None) -> Dict[str, bool]:
        return check_constraints(
            self.workload.patterns,
            self.state,
            self.workload.r_xy,
            self.g.item_size(),
            self.env,
            gamma_max_s or self.config.gamma_max_s,
        )
