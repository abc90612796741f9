"""GeoGraphStore — the public facade of the GeoLayer system.

Ties together: layered-graph construction (§IV), overlap-centric replica
placement (§V), stepwise routing (§VI), cost accounting (§III) and the
update-maintenance strategy (§V "Update Maintenance"): heat-based eviction,
demand-driven pre-caching, streaming topology updates with a warm DHD
field, cost-bounded replica migration, compaction and workload updates.

The device work — the DHD diffusions of placement, pre-caching and
maintenance, the warm DHD sweeps of streaming updates, and the fused routing
expansion of ``serve_batch`` — runs on ``device`` (``None`` = the card,
``"cpu"`` = the plain versions on the host).  The competitor strategies of
``core.baselines`` (placement and table routing) and offline planning run
on the host, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import baselines
from ..demand import ODDemandLayer
from ..device import DeviceLike, resolve_device
from ..obs import Tracer, get_registry
from .cost import CostBreakdown, PlacementState, check_constraints, total_cost
from .graph import Graph, grow_item_rows
from .latency import GeoEnvironment
from .layered_graph import LayeredGraph, build_layered_graph, repair_layered_graph
from .patterns import Pattern, Workload
from .placement import (
    HeatCache,
    PlacementConfig,
    PlacementJournal,
    overlap_centric_placement,
    precache_hot_regions,
    step_heat_caches,
)
from .route_index import RouteIndex
from .route_tables import RouteTables
from .routing import (
    OfflineLayout,
    RouteResult,
    route_offline,
    route_online,
    route_online_batch,
)

__all__ = ["GeoGraphStore", "StoreStats", "UpdateReport"]


@dataclasses.dataclass
class StoreStats:
    placement_stats: Dict[str, object]
    build_time_s: float
    placement_time_s: float


@dataclasses.dataclass
class UpdateReport:
    """Outcome of one ``apply_updates`` batch."""

    n_add_vertices: int
    n_del_vertices: int
    n_add_edges: int
    n_del_edges: int
    n_touched_vertices: int
    repair: object  # core.layered_graph.RepairStats
    heat: object  # streaming.delta_dhd.WarmStats
    apply_time_s: float
    compacted: bool = False  # tombstone-ratio compaction fired this batch

    @property
    def heat_residual(self) -> float:
        """Staleness carried over by the budgeted warm DHD solve: the sup-norm
        change one more sweep would make.  ~0 means the field is at its
        equilibrium; larger values mean later batches / ``maintain()`` still
        owe relaxation work (the operator-visible drift metric)."""
        return float(getattr(self.heat, "residual", 0.0) or 0.0)


class GeoGraphStore:
    """Geo-distributed graph store with GeoLayer placement + routing.

    The data-plane kernel of the system: placement state, routing tables,
    heat fields and their incremental maintenance primitives
    (``serve_batch`` / ``apply_updates`` / ``plan_flush`` + ``begin_flush``
    / ``maintain`` / ``compact`` / ``precache``).

    Strategy knobs allow the ablation grid of paper Fig. 16:
      placement in {"geolayer", "random", "top", "adp", "dcd"},
      routing   in {"stepwise", "random", "greedy"}.
    Stepwise routing serves through :func:`route_online_batch` on the
    store's device whatever the placement; the table routings serve on the
    host.

    ``state`` adopts an existing placement instead of running one (see
    :func:`repro_torch.convert.store_from_numpy`): the layered graph, route
    index, demand plane and heat caches are built as usual around it; under
    a table routing its ``route`` is adopted as it is.
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
        compact_ratio: float = 0.30,
        tracer: Optional[Tracer] = None,
        registry=None,
        demand_window_s: float = 60.0,
        device: DeviceLike = None,
        state: Optional[PlacementState] = None,
    ) -> None:
        self.g = g
        self.env = env
        self.workload = workload
        self.config = config or PlacementConfig()
        self.placement_name = placement
        self.routing_name = routing
        self.device = resolve_device(device)
        self.compact_ratio = compact_ratio
        self.tracer = tracer if tracer is not None else Tracer(clock=time.perf_counter)
        self._registry = registry
        # wall-clock seconds of the last serve_batch routing pass
        self.last_serve_seconds = 0.0
        self.route_index: Optional[RouteIndex] = None
        # each item's replica bitmask and bytes keyed by item id, following
        # the route index's events; handed to the router with the index (the
        # bytes on the host, the bitmasks and bytes on the store's device)
        self.route_tables = RouteTables(
            lambda: self.state.delta, lambda: self.g.item_size(), lambda: self.lg.n_layers,
            devices=[self.device], tracer=self.tracer,
        )
        # content-stable uid per item row: assigned monotonically at birth,
        # row-selected (never renumbered) on compaction.  Placement-journal
        # fingerprints digest uids instead of raw rows, so memo keys survive
        # the compaction renumbering.
        self._item_uid = np.arange(g.n_items, dtype=np.int64)
        self._next_uid = int(g.n_items)
        # bumped on every id-space change (mutation batch, compaction);
        # begin_flush captures it so a WaveApplier outlives neither
        self._id_epoch = 0
        # called with imap (old row -> new row, -1 = dropped) after the
        # store has fully re-keyed itself, so holders of raw item rows can
        # remap instead of dangling
        self._remap_listeners: List = []
        # memo of placement intermediates; populated by every geolayer
        # placement run, replayed by insert_patterns_incremental, remapped
        # in place across compaction, discarded on topology mutations
        self._placement_journal = self._fresh_journal()
        with self.tracer.span("store.build_layered_graph", track="store") as sp_build:
            self.lg: LayeredGraph = build_layered_graph(
                g, env, latency_interval_s=latency_interval_s
            )
        with self.tracer.span("store.place", track="store", strategy=placement) as sp_place:
            if state is None:
                self.state, pstats = self._place(placement, seed)
            else:
                self.state, pstats = state, {"adopted": True}
        with self.tracer.span("store.route", track="store", strategy=routing):
            if state is None or routing == "stepwise":
                self._apply_routing(routing, seed)
            elif routing not in ("random", "greedy"):
                raise ValueError(f"unknown routing {routing!r}")
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
        # streaming-update state (materialized on first apply_updates)
        self._delta_graph = None
        self._heat = None
        self._heat_scale = None

    # ------------------------------------------------------------- telemetry
    def _reg(self):
        """Explicit registry if one was injected, else the process default."""
        return self._registry if self._registry is not None else get_registry()

    # ------------------------------------------------------------ strategies
    def _fresh_journal(self) -> PlacementJournal:
        j = PlacementJournal()
        j.item_uid = self._item_uid
        return j

    def _place(self, name: str, seed: int, route: bool = True) -> Tuple[PlacementState, Dict]:
        if name == "geolayer":
            return overlap_centric_placement(
                self.lg, self.workload, self.config, device=self.device,
                journal=self._placement_journal, route=route,
            )
        if name == "random":
            return (
                baselines.place_random_k(self.g, self.workload, self.env, seed=seed),
                {"baseline": "random-3"},
            )
        if name == "top":
            return (
                baselines.place_top_k(self.g, self.workload, self.env),
                {"baseline": "top-3"},
            )
        if name == "adp":
            return (
                baselines.place_adp(self.g, self.workload, self.env),
                {"baseline": "adp"},
            )
        if name == "dcd":
            return (
                baselines.place_dcd(self.g, self.workload, self.env),
                {"baseline": "dcd"},
            )
        raise ValueError(f"unknown placement {name!r}")

    def _apply_routing(self, name: str, seed: int) -> None:
        self.route_index = None
        if name == "stepwise":
            # per-item nearest-replica table; pattern requests use
            # route_online.  ``state.route`` aliases ``index.nearest`` so
            # incremental patches are visible to every consumer without
            # copies.
            self.route_index = RouteIndex.build(self.state.delta, self.env)
            self.state.route = self.route_index.nearest
            self.route_tables.bind(self.route_index)
        elif name == "random":
            baselines.route_random(self.state, self.workload, self.env, seed=seed)
        elif name == "greedy":
            baselines.route_greedy_set_cover(self.state, self.workload, self.env)
        else:
            raise ValueError(f"unknown routing {name!r}")

    # -------------------------------------------------------------- serving
    def serve_online(self, pattern: Pattern, origin: int) -> RouteResult:
        """Serve one online pattern request; returns the routing outcome."""
        if self.routing_name == "stepwise":
            res = route_online(self.lg, self.state, pattern.items, origin)
        else:
            res = self._route_by_table(pattern.items, origin)
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
        request-for-request.  Stepwise routing resolves the batch through
        :func:`route_online_batch` on the store's device, where the size
        gates pick the fused expansion; table-driven strategies fall back to
        per-request table lookups on the host.
        """
        norm: List[Tuple[np.ndarray, int]] = []
        for req, origin in requests:
            items = req.items if isinstance(req, Pattern) else np.asarray(req)
            norm.append((items, int(origin)))
        t_serve = time.perf_counter()
        with self.tracer.span("store.serve_batch", track="store", size=len(norm)):
            if self.routing_name == "stepwise":
                # serving.* counters/histograms are emitted batch-granular
                # inside route_online_batch, where the flat arrays live
                sizes, tables = self.route_tables.handed(self.route_index, self.device)
                results = route_online_batch(
                    self.lg, self.state, norm, sizes=sizes, registry=self._registry,
                    device=self.device, tracer=self.tracer, tables=tables,
                )
            else:
                results = [self._route_by_table(it, o) for it, o in norm]
                reg = self._reg()
                if reg.enabled and results:
                    self._observe_serving(reg, norm, results)
        self.last_serve_seconds = time.perf_counter() - t_serve
        if observe and norm:
            # heat injection grouped per origin inside the demand plane
            self.demand.observe_requests(norm)
        return results

    def _observe_serving(self, reg, norm, results: List[RouteResult]) -> None:
        """Serving-path counters for the table-driven fallback strategies
        (the stepwise hot path emits these vectorized inside
        :func:`route_online_batch`).  Per-link bytes are reconstructed from
        Eq. 1 — the route result already paid for ``per_dc_latency``, so
        ``(lat - rtt) * bw`` recovers each serving DC's byte volume with
        scalar math (no re-aggregation of the batch)."""
        reg.counter("serving.requests").inc(len(results))
        env = self.env
        wan_total = 0.0
        by_link: Dict[Tuple[int, int], float] = {}
        for (_, origin), r in zip(norm, results):
            wan_total += r.wan_bytes
            if r.wan_bytes <= 0.0:
                continue
            for dc, lat in r.per_dc_latency.items():
                if dc == origin:
                    continue
                nbytes = (lat - env.rtt_s[dc, origin]) * env.bw_Bps[dc, origin]
                key = (dc, origin)
                by_link[key] = by_link.get(key, 0.0) + nbytes
        reg.counter("serving.wan_bytes").inc(wan_total)
        for (src, dst), nbytes in by_link.items():
            reg.counter("serving.wan_bytes_link", src=src, dst=dst).inc(nbytes)
        lat_h = reg.histogram("serving.request_latency_s")
        for r in results:
            lat_h.observe(r.latency_s)

    def _route_by_table(self, items: np.ndarray, origin: int) -> RouteResult:
        sizes = self.g.item_size()
        served = self.state.route[items, origin].astype(np.int64)
        per_dc: Dict[int, float] = {}
        wan = 0.0
        for dc in np.unique(served[served >= 0]):
            s_d = float(sizes[items[served == dc]].sum())
            per_dc[int(dc)] = self.env.request_latency(int(dc), origin, s_d)
            if int(dc) != origin:
                wan += s_d
        return RouteResult(
            served_by=served,
            dcs=np.unique(served[served >= 0]),
            latency_s=max(per_dc.values()) if per_dc else 0.0,
            per_dc_latency=per_dc,
            layers_used=0,
            n_missing=int((served < 0).sum()),
            wan_bytes=wan,
        )

    def plan_offline(
        self, required_items: np.ndarray, n_iters: int = 15, msg_bytes: float = 16.0
    ) -> OfflineLayout:
        return route_offline(
            self.lg, self.state, required_items, n_iters=n_iters, msg_bytes=msg_bytes
        )

    # ---------------------------------------------------------- maintenance
    def _resync_route_index(self) -> None:
        """Re-adopt the routing table if external code orphaned the alias
        (a full ``state.route_nearest(env)`` replaces ``state.route``)."""
        if self.route_index is not None and self.state.route is not self.route_index.nearest:
            self.route_index.rebuild(self.state.delta)
            self.state.route = self.route_index.nearest

    def maintain(self, evict: bool = True, diffusion_steps: int = 4) -> Dict[str, float]:
        """Periodic maintenance: heat diffusion + cold-replica eviction
        (Alg. 3), routing refresh, and working off any warm-DHD residual.

        With a :class:`RouteIndex` the eviction refresh patches only the rows
        whose replica sets actually shrank; the table routings re-derive the
        whole table."""
        with self.tracer.span("store.maintain", track="store"):
            self._resync_route_index()
            evicted = 0
            # all per-DC caches share one topology -> ONE batched diffusion
            step_heat_caches(list(self.caches.values()), n_steps=diffusion_steps)
            for dc, cache in self.caches.items():
                if evict:
                    ids = cache.evict()
                    evicted += len(ids)
                    if self.route_index is not None:
                        self.route_index.drop_replicas(self.state.delta, ids, dc)
            if self.route_index is None:
                self.state.route_nearest(self.env)
            residual = 0.0
            if self._heat is not None and self._heat.heat is not None:
                # budgeted apply_updates sweeps may leave the heat field short
                # of equilibrium; the maintenance window pays that debt down
                self._heat.solve()
                residual = self._heat.residual
            return {"evicted": evicted, "heat_residual": residual}

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
            if self.route_index is not None:
                self.route_index.patch_rows(self.state.delta, changed)
            else:
                from ..streaming.migration import _reroute_items

                _reroute_items(self.state, self.env, changed)
        return changed

    # ----------------------------------------------------- workload updates
    def delete_items(self, item_ids: np.ndarray) -> None:
        """Bottom-up delete cleanup: drop all replicas everywhere (§V)."""
        self._resync_route_index()
        ids = np.asarray(item_ids)
        self.state.delta[ids] = False
        if self.route_index is not None:
            self.route_index.clear_rows(ids)
        else:
            self.state.route[ids] = -1

    def insert_patterns(self, new_patterns: Sequence[Pattern]) -> None:
        """Full refresh: materialize new access patterns and re-run placement
        and routing from scratch (periodic refresh path of §V).

        The journal is reset first so this really is a cold re-place (and is
        freshly populated for later incremental inserts).  Heat caches are
        re-pointed at the new :class:`PlacementState`."""
        self.workload = Workload.from_patterns(
            list(self.workload.patterns) + list(new_patterns),
            self.workload.n_items,
            self.workload.n_dcs,
        )
        self._placement_journal = self._fresh_journal()
        self.state, pstats = self._place(self.placement_name, seed=0)
        self._apply_routing(self.routing_name, seed=0)
        for cache in self.caches.values():
            cache.state = self.state
        self.stats.placement_stats = pstats

    def insert_patterns_incremental(
        self, new_patterns: Sequence[Pattern]
    ) -> Dict[str, object]:
        """Absorb new access patterns without the full re-place.

        Replays Algorithms 1+2 over the extended workload *through the
        placement journal*: pools the new patterns never touch are journal
        hits (their decomposition, region adjacency and batched DHD heat
        tables are replayed, not recomputed), so only the affected BSs/pools
        pay compute.  The resulting replica sets are identical to
        :meth:`insert_patterns` by construction.  The deltas are then
        patched **in place**: ``state.delta`` rows are updated (the
        :class:`PlacementState` object and its aliases survive) and only the
        changed rows of the :class:`RouteIndex` are re-derived.

        Returns a report dict (changed rows, journal hit/miss counters,
        wall time).  Non-geolayer placements have no incremental structure
        to exploit, and non-stepwise routing policies (random/greedy) derive
        their whole table from the final placement — both fall back to
        :meth:`insert_patterns` so the routing policy is never silently
        mixed with nearest-replica patches.
        """
        if self.placement_name != "geolayer" or self.routing_name != "stepwise":
            self.insert_patterns(new_patterns)
            return {"fallback": "full", "n_new": len(new_patterns)}
        with self.tracer.span(
            "store.insert_patterns_incremental", track="store",
            n_new=len(new_patterns),
        ) as root:
            self.workload = Workload.from_patterns(
                list(self.workload.patterns) + list(new_patterns),
                self.workload.n_items,
                self.workload.n_dcs,
            )
            j = self._placement_journal
            hits0, miss0 = j.hits, j.misses
            with self.tracer.span("store.replay_placement", track="store"):
                new_state, pstats = self._place(
                    self.placement_name, seed=0, route=False
                )
            changed = np.where((new_state.delta != self.state.delta).any(axis=1))[0]
            self.state.delta[changed] = new_state.delta[changed]
            with self.tracer.span(
                "store.patch_routes", track="store", rows=int(len(changed))
            ):
                self._resync_route_index()
                self.route_index.patch_rows(self.state.delta, changed)
            self.stats.placement_stats = pstats
            return {
                "n_new": len(new_patterns),
                "rows_changed": int(len(changed)),
                "journal_hits": j.hits - hits0,
                "journal_misses": j.misses - miss0,
                "apply_time_s": root.elapsed_s(),
            }

    # ---------------------------------------------------- streaming updates
    def _new_heat(self, **kw):
        from ..streaming.delta_dhd import StreamingHeat

        return StreamingHeat(device=self.device, **kw)

    def _heat_inputs(self):
        """(alive edge ids, edge weights, vertex sources) for streaming DHD.

        Normalization scales are frozen at first use: the warm path only
        rewrites *touched* ELL rows, so renormalizing by the current max each
        batch would leave untouched rows on a stale scale and the field would
        drift from any cold rebuild."""
        g = self.g
        alive_e = (
            np.where(self._delta_graph.edge_alive)[0]
            if self._delta_graph is not None
            else np.arange(g.n_edges)
        )
        w_e = self.workload.r_xy[g.n_nodes:].sum(axis=1)[alive_e].astype(np.float32)
        r_v = self.workload.r_xy[: g.n_nodes].sum(axis=1).astype(np.float32)
        if self._heat_scale is None:
            self._heat_scale = (
                max(float(w_e.max()) if len(w_e) else 1.0, 1.0),
                max(float(r_v.max()), 1e-12),
            )
        w_scale, q_scale = self._heat_scale
        return alive_e, w_e / w_scale + 1e-3, r_v / q_scale

    def apply_updates(self, batch) -> UpdateReport:
        """Absorb one :class:`~repro_torch.streaming.MutationBatch` incrementally.

        Instead of the full rebuild path (``build_layered_graph`` +
        ``overlap_centric_placement`` + global reroute) this: grows the
        delta-CSR overlay, repairs only the invalidated latency layers,
        deposits primary replicas for new items / purges dead ones, reroutes
        exactly the touched rows, and warm-starts DHD from the previous
        equilibrium on the store's device.  Replica migration is deferred to
        :meth:`flush_migrations` so bursts of batches amortize one move-set.
        """
        root = self.tracer.span(
            "store.apply_updates", track="store", n_ops=int(batch.n_ops)
        )
        try:
            return self._apply_updates_traced(batch, root)
        finally:
            root.end()

    def _apply_updates_traced(self, batch, root) -> UpdateReport:
        from ..streaming.migration import _reroute_items
        from ..streaming.mutation_log import DeltaGraph

        self._resync_route_index()
        if self._delta_graph is None:
            self._delta_graph = DeltaGraph(self.g)
        dg = self._delta_graph
        if batch.n_ops == 0:  # no-op batch: skip repair/heat entirely
            return UpdateReport(0, 0, 0, 0, 0, None, None, root.elapsed_s())
        # mutations change the edge topology -> journaled region adjacency
        # and heat tables die
        self._id_epoch += 1  # id space shifts; in-flight flushes go stale
        res = dg.apply(batch)
        g2 = dg.g
        old_n = res.old_n_nodes
        nv, ne = res.n_new_vertices, len(res.new_edge_ids)

        # --- remap item-indexed state to the shifted id space -------------
        self._item_uid = grow_item_rows(self._item_uid, old_n, nv, ne, -1)
        born = np.where(self._item_uid < 0)[0]
        self._item_uid[born] = np.arange(
            self._next_uid, self._next_uid + len(born), dtype=np.int64
        )
        self._next_uid += len(born)
        self._placement_journal = self._fresh_journal()
        self.state.delta = grow_item_rows(self.state.delta, old_n, nv, ne, False)
        if self.route_index is None:
            self.state.route = grow_item_rows(self.state.route, old_n, nv, ne, -1)
        wl = self.workload
        r2 = grow_item_rows(wl.r_xy, old_n, nv, ne, 0.0)
        w2 = grow_item_rows(wl.w_xy, old_n, nv, ne, 0.0)
        dead_items = res.dead_item_ids(g2.n_nodes)
        dead_mask = np.zeros(g2.n_items, dtype=bool)
        dead_mask[dead_items] = True
        pats = []
        for p in wl.patterns:
            items = res.remap_items(p.items)
            items = items[~dead_mask[items]]
            pats.append(Pattern(pid=p.pid, items=items, r_py=p.r_py, w_py=p.w_py, eta=p.eta))
        self.workload = Workload(
            patterns=pats, n_items=g2.n_items, n_dcs=wl.n_dcs, r_xy=r2, w_xy=w2
        )
        # the demand plane grows all its item-indexed tables once; the
        # caches' heat rows are views and follow automatically
        self.demand.grow_items(old_n, nv, ne)
        for cache in self.caches.values():
            cache.g = g2
            cache.edge_mask = dg.edge_alive
        self.g = g2

        # --- incremental layered-graph repair ----------------------------
        with self.tracer.span("store.repair_layers", track="store"):
            self.lg, rstats = repair_layered_graph(self.lg, g2, dg.edge_alive)

        # --- primaries for new items, bottom-up delete cleanup -----------
        if nv:
            self.state.delta[res.new_vertex_ids, g2.partition[res.new_vertex_ids]] = True
        if ne:
            e = res.new_edge_ids
            self.state.delta[g2.n_nodes + e, g2.partition[g2.src[e]]] = True
        self.state.delta[dead_items] = False
        if self.route_index is None:
            self.state.route[dead_items] = -1
        r2[dead_items] = 0.0
        w2[dead_items] = 0.0

        # --- reroute only the rows whose replica sets changed -------------
        changed = np.unique(np.concatenate([res.new_item_ids(g2.n_nodes), dead_items]))
        with self.tracer.span(
            "store.reroute", track="store", rows=int(len(changed))
        ):
            if self.route_index is not None:
                # the index grows its own rows (edge block shifts by nv),
                # clears the tombstoned ones and derives exactly the changed
                # rows
                self.route_index.apply_batch(
                    self.state.delta, old_n, nv, ne, changed, dead_items
                )
                self.state.route = self.route_index.nearest
            else:
                _reroute_items(self.state, self.env, changed)

        # --- warm-start DHD over the alive topology -----------------------
        # Migration planning only *ranks* items by heat, so the store runs a
        # bounded relaxation budget per batch instead of iterating to full
        # tolerance (any leftover residual is worked off by later batches or
        # maintain()).  The StreamingHeat defaults remain exact for
        # standalone users.
        if self._heat is None:
            self._heat = self._new_heat(tol=1e-5, max_iters=32)
        alive_e, w_e, q = self._heat_inputs()
        with self.tracer.span("store.warm_heat", track="store"):
            hstats = self._heat.update(
                g2.n_nodes, g2.src[alive_e], g2.dst[alive_e], w_e, q,
                touched=res.touched_vertices,
            )

        # --- notify raw-row holders of the id-space shift -----------------
        # Vertex inserts shift every edge-item row by nv; subscribers re-key
        # through the same growth map the store's own state grew through,
        # with tombstoned rows dropped.  Fired before the compaction trigger
        # below so a same-batch compaction's imap composes cleanly.
        if self._remap_listeners:
            old_n_items = old_n + (g2.n_edges - ne)
            imap_g = np.empty(old_n_items, dtype=np.int64)
            imap_g[:old_n] = np.arange(old_n)
            imap_g[old_n:] = old_n + nv + np.arange(old_n_items - old_n)
            imap_g[dead_mask[imap_g]] = -1
            self._fire_remap_listeners(imap_g)

        # --- tombstone-ratio compaction trigger ---------------------------
        # The delta overlay grows without bound otherwise: tombstoned rows
        # keep occupying every [I, D] array and every ELL row forever.
        compacted = False
        if self.tombstone_ratio() >= self.compact_ratio:
            self._compact_in_place()
            compacted = True
        return UpdateReport(
            n_add_vertices=nv,
            n_del_vertices=len(res.dead_vertex_ids),
            n_add_edges=ne,
            n_del_edges=len(res.dead_edge_ids),
            n_touched_vertices=len(res.touched_vertices),
            repair=rstats,
            heat=hstats,
            apply_time_s=root.elapsed_s(),
            compacted=compacted,
        )

    def tombstone_ratio(self) -> float:
        """Fraction of item rows that are tombstones (dead vertices+edges)."""
        dg = self._delta_graph
        if dg is None:
            return 0.0
        total = dg.g.n_items
        alive = dg.n_alive_nodes + dg.n_alive_edges
        return 1.0 - alive / max(total, 1)

    def compact(self) -> bool:
        """Fold the delta overlay eagerly (maintenance-window compaction).

        ``apply_updates`` compacts reactively at ``compact_ratio``; a
        maintenance policy calls this proactively when an idle gap can
        absorb the cost.  No-op (False) when there is no overlay or no
        tombstone to reclaim."""
        if self._delta_graph is None or self.tombstone_ratio() <= 0.0:
            return False
        self._compact_in_place()
        return True

    def add_remap_listener(self, fn) -> None:
        """Register ``fn(imap)`` to fire after every id-space re-keying —
        mutation-batch growth (vertex inserts shift the edge block) as well
        as compaction (``imap[old_row] -> new_row``, -1 = dropped) — with
        the store already fully consistent in the new id space.

        Bound methods are held weakly: when the subscriber is
        garbage-collected, its entry is pruned on the next re-keying instead
        of pinning it alive forever."""
        import weakref

        try:
            self._remap_listeners.append(weakref.WeakMethod(fn))
        except TypeError:  # plain function/lambda: hold strongly
            self._remap_listeners.append(lambda _fn=fn: _fn)

    def _fire_remap_listeners(self, imap: np.ndarray) -> None:
        live = []
        for ref in self._remap_listeners:
            fn = ref()
            if fn is not None:
                fn(imap)
                live.append(ref)
        self._remap_listeners = live

    def _compact_in_place(self) -> None:
        """Re-key every item-indexed structure onto the dense compacted graph.

        Placement rows, the route index, workload frequencies, heat caches
        and the warm DHD field are all row-selected/remapped in place; the
        layered graph is rebuilt from the compact graph (compaction renumbers
        ids, so the stable-id repair path does not apply) and a fresh
        :class:`~repro_torch.streaming.DeltaGraph` takes over with zero
        tombstones.
        """
        sp = self.tracer.span(
            "store.compact", track="store",
            tombstone_ratio=round(self.tombstone_ratio(), 4),
        )
        with sp:
            self._compact_in_place_traced()

    def _compact_in_place_traced(self) -> None:
        from ..streaming.mutation_log import DeltaGraph

        dg = self._delta_graph
        old_n = self.g.n_nodes
        gc, vmap, emap = dg.compact()
        vkeep = np.where(dg.node_alive)[0]
        ekeep = np.where(dg.edge_alive)[0]
        # new row order: alive vertices (old order), then alive edges
        keep = np.concatenate([vkeep, old_n + ekeep])
        self._item_uid = self._item_uid[keep]

        # placement rows + route index
        self.state.delta = self.state.delta[keep]
        if self.route_index is not None:
            self.route_index.take_rows(keep)
            self.state.route = self.route_index.nearest
        else:
            self.state.route = self.state.route[keep]

        # workload: remap pattern items, row-select aggregated frequencies
        imap = np.full(old_n + len(emap), -1, dtype=np.int64)
        imap[:old_n] = vmap
        imap[old_n:] = np.where(emap >= 0, gc.n_nodes + emap, -1)
        # journal keys digest uids (compaction-stable); only the row-indexed
        # memo values need rewriting onto the renumbered id space
        self._placement_journal.remap(imap, self._item_uid)
        pats = []
        for p in self.workload.patterns:
            it = imap[p.items]
            pats.append(
                Pattern(pid=p.pid, items=it[it >= 0], r_py=p.r_py, w_py=p.w_py, eta=p.eta)
            )
        self.workload = Workload(
            patterns=pats,
            n_items=gc.n_items,
            n_dcs=self.workload.n_dcs,
            r_xy=self.workload.r_xy[keep],
            w_xy=self.workload.w_xy[keep],
        )

        # demand plane: row-select every item-indexed table; the caches'
        # heat rows are views and follow.  Drop the (now all-True) edge mask.
        self.demand.take_rows(keep)
        for cache in self.caches.values():
            cache.g = gc
            cache.edge_mask = None

        # layered graph: rebuild on the renumbered graph, same thresholds
        self.lg = build_layered_graph(
            gc, self.env, thresholds_s=self.lg.thresholds_s
        )

        # warm DHD: re-key the equilibrium field, rebuild the ELL warm
        self.g = gc
        self._delta_graph = DeltaGraph(gc)
        if self._heat is not None and self._heat.heat is not None:
            h0 = self._heat.vertex_heat[vkeep].copy()
            alive_e, w_e, q = self._heat_inputs()
            self._heat.rebuild(
                gc.n_nodes, gc.src[alive_e], gc.dst[alive_e], w_e, q, heat0=h0
            )

        # the store is consistent in the new id space: stale-flush guards
        # trip from here on, and raw-row holders get their remap shot
        self._id_epoch += 1
        self._fire_remap_listeners(imap)

    # ------------------------------------------------------------ migration
    def plan_flush(
        self,
        budget_bytes: Optional[float] = None,
        window_s: Optional[float] = 60.0,
        schedule: str = "ff",
        **kw,
    ):
        """Plan (but do not apply) the cost-bounded replica move-set for the
        heat drift accumulated since the last flush.

        Returns a :class:`~repro_torch.streaming.MigrationPlan`; with a
        ``window_s`` its ``.schedule`` holds the per-link transfer waves
        (``schedule`` picks the packing: ``"ff"`` priority-order first-fit,
        ``"lpt"`` makespan-aware).  Pure planning: the placement, route
        index and heat state are read, never written.

        ``item_heat=`` / ``read_rates=`` (forwarded through ``**kw``) inject
        the demand tables the planner optimizes against instead of the
        default warm-DHD equilibrium over the static workload."""
        if schedule not in ("ff", "lpt"):
            # validated here too: with window_s=None schedule_transfers (the
            # authority on packing names) never runs
            raise ValueError(f"unknown packing {schedule!r} (want 'ff' or 'lpt')")
        with self.tracer.span("store.plan_flush", track="store"):
            return self._plan_flush_traced(budget_bytes, window_s, schedule, **kw)

    def _plan_flush_traced(
        self, budget_bytes, window_s, schedule,
        item_heat=None, read_rates=None, **kw,
    ):
        from ..streaming.migration import plan_migrations, schedule_transfers

        self._resync_route_index()
        sizes = self.g.item_size()
        if budget_bytes is None:
            budget_bytes = 0.05 * float(sizes.sum())
        if self._delta_graph is not None:
            item_alive = np.concatenate(
                [self._delta_graph.node_alive, self._delta_graph.edge_alive]
            )
        else:
            item_alive = np.ones(self.g.n_items, dtype=bool)
        if item_heat is None:
            # reactive default: warm-DHD equilibrium over the workload tables
            if self._heat is None or self._heat.heat is None:
                # never churned: cold-solve the equilibrium once
                self._heat = self._new_heat()
                alive_e, w_e, q = self._heat_inputs()
                self._heat.rebuild(
                    self.g.n_nodes, self.g.src[alive_e], self.g.dst[alive_e], w_e, q
                )
            vheat = self._heat.vertex_heat
            eheat = 0.5 * (vheat[self.g.src] + vheat[self.g.dst])
            item_heat = np.concatenate([vheat, eheat]) * item_alive
        else:
            # injected demand-plane view (measured or forecast): no DHD solve
            item_heat = np.asarray(item_heat, dtype=np.float64) * item_alive
        r_xy = self.workload.r_xy if read_rates is None else np.asarray(read_rates)
        plan = plan_migrations(
            self.g, self.env, self.state, r_xy, self.workload.w_xy,
            item_heat, budget_bytes, item_alive=item_alive, **kw,
        )
        if window_s is not None:
            plan.schedule = schedule_transfers(
                plan, self.env, window_s, schedule=schedule
            )
        return plan

    def begin_flush(
        self,
        budget_bytes: Optional[float] = None,
        window_s: float = 60.0,
        schedule: str = "ff",
        **kw,
    ):
        """Plan a scheduled flush and hand back ``(plan, WaveApplier)``.

        The caller lands waves one at a time into idle gaps via
        ``applier.apply_next()`` and releases drops with
        ``applier.finish()``.  Zero-byte local adds land immediately.

        The applier is epoch-guarded: if a mutation batch or compaction
        renumbers the item id space while waves are still pending, the next
        ``apply_next()``/``finish()`` raises
        :class:`~repro_torch.streaming.migration.StaleFlushError` instead of
        applying stale rows — re-plan with a fresh ``begin_flush``."""
        from ..streaming.migration import WaveApplier

        if window_s is None:
            raise ValueError("begin_flush needs a window_s (waves to step)")
        plan = self.plan_flush(budget_bytes, window_s, schedule=schedule, **kw)
        epoch = self._id_epoch
        applier = WaveApplier(
            plan, self.state, self.env, self.workload.patterns,
            self._guard_rates(kw), self.g.item_size(), self.config.gamma_max_s,
            route_index=self.route_index,
            valid_check=lambda: self._id_epoch == epoch,
        )
        return plan, applier

    def _guard_rates(self, plan_kw) -> np.ndarray:
        """The demand table the Eq. 6 constraint guard holds the flush to:
        the one the plan was made against (an injected ``read_rates`` view,
        else the workload's ``r_xy``), so plan and guard judge the same
        demand."""
        rates = plan_kw.get("read_rates")
        if rates is None:
            return self.workload.r_xy
        return np.asarray(rates, dtype=np.float64)

    def flush_migrations(
        self,
        budget_bytes: Optional[float] = None,
        window_s: Optional[float] = 60.0,
        on_wave=None,
        schedule: str = "ff",
        **kw,
    ):
        """Plan + apply the cost-bounded replica move-set for the heat drift
        accumulated since the last flush.

        With a ``window_s`` (the default) accepted adds are scheduled into
        per-(src, dst) transfer waves under the per-link byte budgets
        ``env.link_budget_bytes(window_s)`` and applied **wave by wave**:
        after each wave the placement and :class:`RouteIndex` are mutually
        consistent, ``on_wave(wave)`` fires, and drops are released only
        once every transfer has landed.  ``window_s=None`` keeps the
        single-shot application.

        Returns the :class:`~repro_torch.streaming.MigrationPlan` with
        ``plan.schedule`` attached and ``rolled_back`` set if the constraint
        guard reverted drops."""
        from ..streaming.migration import apply_plan

        plan = self.plan_flush(budget_bytes, window_s, schedule=schedule, **kw)
        apply_plan(
            plan, self.state, self.env, self.workload.patterns,
            self._guard_rates(kw), self.g.item_size(), self.config.gamma_max_s,
            route_index=self.route_index,
            schedule=plan.schedule,
            on_wave=on_wave,
        )
        return plan

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
