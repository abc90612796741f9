"""Overlap-centric replica placement (paper §V, Algorithms 1-3, Eq. 13).

Flow (level-synchronous rendering of Algorithms 1+2):

1. **Sinking** (Alg. 1): each pattern enters the layer whose latency interval
   contains its SLO ``eta_p * Gamma_max`` — edges above that layer are too slow
   to cross at serve time, so the pattern is held independently by every
   requesting bridge subgraph (BS) of its target layer.
2. **Per layer k = h..1** (Alg. 2):
   * Phase 1 — every unit held by a BS is tested with the replication gain
     (Eq. 13): gain >= 0 -> full replication into all requesting child BSs
     (one layer down); gain < 0 -> deferred to the cluster's decomposition
     pool.
   * Phase 2 — each pool is split into disjoint overlap regions (Venn cells);
     per region: gain > 0 -> replicate across the cluster's requesting BSs,
     else a **DHD competition** (paper Fig. 4b): each candidate BS seeds heat
     at its current holdings, diffuses over the region graph, and the region
     goes to the BS whose heat reaches it strongest (frequency fallback).
   * Units that reach layer 0 are deposited as replicas in the DCs.
3. **Pre-caching** (§V) — steady-state DHD over the whole graph identifies
   high-heat vertices (>= theta quantile) cached at every non-owning DC.
4. **Eviction** (Alg. 3) — online heat tracking; items whose diffused heat
   falls below ``theta_c`` are evicted.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import dhd
from ..device import DeviceLike
from ..obs import get_registry
from .cost import PlacementState
from .graph import Graph
from .latency import GeoEnvironment
from .layered_graph import LayeredGraph
from .patterns import (
    OverlapRegion,
    Pattern,
    Workload,
    decompose_overlap_regions,
    region_adjacency,
)

__all__ = [
    "PlacedUnit",
    "PlacementConfig",
    "replication_gain",
    "CompetitionArena",
    "overlap_centric_placement",
    "precache_hot_regions",
    "HeatCache",
    "step_heat_caches",
]


@dataclasses.dataclass
class PlacedUnit:
    """A pattern or overlap region flowing down the layered graph."""

    items: np.ndarray
    r_py: np.ndarray  # [D]
    w_py: np.ndarray  # [D]
    eta: float
    key: Tuple[int, ...]  # source pattern ids (region identity)

    @staticmethod
    def from_pattern(p: Pattern) -> "PlacedUnit":
        return PlacedUnit(
            items=p.items, r_py=p.r_py, w_py=p.w_py, eta=p.eta, key=(p.pid,)
        )


@dataclasses.dataclass
class PlacementConfig:
    gamma_max_s: float = 0.5  # latency SLO upper bound (paper: 500 ms fraud)
    lambda1: float = 0.5
    lambda2: float = 0.5
    dhd: dhd.DHDParams = dataclasses.field(default_factory=dhd.DHDParams)
    dhd_steps: int = 32
    # one batched diffusion per pool (CompetitionArena) instead of one
    # diffusion per (candidate, region); winner-identical to the sequential
    # path (differentially tested), False keeps the per-call reference
    dhd_batch: bool = True
    precache: bool = True
    theta_quantile: float = 0.55  # paper Fig. 12: 50-60% is near-optimal
    precache_max_per_dc: int = 4096


# ------------------------------------------------------------------ Eq. (13)
def replication_gain(
    unit: PlacedUnit,
    holder_dcs: np.ndarray,
    children_dcs: List[np.ndarray],
    sizes: np.ndarray,
    env: GeoEnvironment,
    lambda1: float = 0.5,
    primary: Optional[np.ndarray] = None,
) -> float:
    """Surrogate replication gain (Eq. 13) of fully replicating ``unit``
    into each requesting child region.

    gain = dC^R (cross-reads become local) + dC^A (lambda1 * eliminated
    cross-BS routings) - dC^S (added storage) - dC^W (added sync).
    Prices are averaged over the concrete DC pairs involved, so the surrogate
    tracks the real cost model's geometry (cluster-local, Appendix D).
    """
    items = unit.items
    item_sizes = sizes[items]
    size_sum = float(item_sizes.sum())
    n_items = len(items)
    holder = np.unique(np.asarray(holder_dcs, dtype=np.int64))
    w_total = float(unit.w_py.sum())
    primary_items = primary[items] if primary is not None else None
    gain = 0.0
    for child in children_dcs:
        child_arr = np.asarray(child, dtype=np.int64)
        r_c = float(unit.r_py[child_arr].sum())
        if r_c <= 0:
            continue
        # reads of items whose primary already sits in the child region are
        # local without a replica — only *remote* bytes produce savings
        # (without this the surrogate over-replicates write-heavy patterns;
        # measured: Fig. 9 optimality gap 20.7% -> see bench_output)
        if primary_items is not None:
            size_remote = float(item_sizes[~np.isin(primary_items, child_arr)].sum())
        else:
            size_remote = size_sum
        outside = holder[~np.isin(holder, child_arr)]
        if len(outside) == 0:
            outside = holder
        # mean $/byte of the cross-cluster paths this replication removes
        net_mean = float(env.c_net[np.ix_(outside, child_arr)].mean())
        store_mean = float(env.c_store[child_arr].mean())
        put_mean = float(env.c_write[child_arr].mean())
        read_save = r_c * size_remote * net_mean
        assoc_save = lambda1 * r_c * n_items * 1e-6  # assoc unit ~ per-M GETs
        store_add = size_sum * store_mean
        write_add = w_total * (put_mean * n_items + size_remote * net_mean)
        gain += read_save + assoc_save - store_add - write_add
    return gain


# ----------------------------------------------------------- DHD competition
def _dhd_competition(
    region: OverlapRegion,
    candidates: List[Tuple[int, np.ndarray, List[np.ndarray]]],
    all_regions: Sequence[OverlapRegion],
    g: Graph,
    params: dhd.DHDParams,
    n_steps: int,
    unit_r: np.ndarray,
    device: DeviceLike = None,
) -> int:
    """Pick the winning candidate (index into ``candidates``) for ``region``.

    ``candidates`` entries are (bs_index, dcs, held_item_arrays).  Each
    candidate seeds heat at a super-node representing its current holdings
    connected to the candidate regions by graph-edge counts (Fig. 4b); the
    region goes to the candidate whose diffused heat at it is largest.
    Fallback: total access frequency of the candidate's DCs for the region.
    """
    n_regions = len(all_regions)
    rsrc, rdst, rw = region_adjacency(all_regions, g)
    item_region = np.full(g.n_items, -1, dtype=np.int64)
    for r in all_regions:
        item_region[r.items] = r.rid
    scores = []
    for (_, dcs, held_items) in candidates:
        if held_items:
            held = np.unique(np.concatenate(held_items))
        else:
            held = np.zeros(0, dtype=np.int64)
        if len(held) == 0 or len(rsrc) == 0:
            scores.append(-1.0)
            continue
        # connect the holdings super-node (id = n_regions) to regions that
        # share graph edges with the held items
        held_mask = np.zeros(g.n_items, dtype=bool)
        held_mask[held] = True
        touch_src = held_mask[g.src] & (item_region[g.dst] >= 0)
        touch_dst = held_mask[g.dst] & (item_region[g.src] >= 0)
        extra: Dict[int, float] = {}
        for rid in item_region[g.dst[touch_src]]:
            extra[int(rid)] = extra.get(int(rid), 0.0) + 1.0
        for rid in item_region[g.src[touch_dst]]:
            extra[int(rid)] = extra.get(int(rid), 0.0) + 1.0
        if not extra:
            scores.append(-1.0)
            continue
        esrc = np.array([n_regions] * len(extra), dtype=np.int64)
        edst = np.array(list(extra.keys()), dtype=np.int64)
        ew = np.array(list(extra.values()), dtype=np.float32)
        seed = np.zeros(n_regions + 1, dtype=np.float32)
        seed[n_regions] = 1.0
        heat = dhd.diffuse_affinity(
            n_regions + 1,
            np.concatenate([rsrc, esrc]),
            np.concatenate([rdst, edst]),
            np.concatenate([rw, ew]),
            seed,
            params=params,
            n_steps=n_steps,
            device=device,
        )
        scores.append(float(heat[region.rid]))
    scores_arr = np.asarray(scores)
    if scores_arr.max() > 0:
        return int(scores_arr.argmax())
    # unreachable by heat -> frequency of the candidate DCs for this region
    freq = [float(unit_r[dcs].sum()) for (_, dcs, _) in candidates]
    return int(np.asarray(freq).argmax())


# --------------------------------------------------- batched DHD competition
class CompetitionArena:
    """Per-pool batched DHD competition (one diffusion for every candidate).

    A candidate's diffused heat field depends only on the region graph, its
    own super-node edges and the (shared) seed — *not* on which region is
    being contested.  So a pool with R regions and C candidates needs C
    diffusions, not R x C: the arena hoists ``region_adjacency`` once, builds
    every candidate's super-node edge weights with ``np.add.at`` over a
    shared edge-list union (weight 0 = edge absent for that candidate, see
    the weight gate in :func:`repro_torch.core.dhd.dhd_step_edges`), and runs ONE
    batched diffusion producing a ``[C, R+1]`` heat table.  Per-region
    winners read from the table with exactly the scoring/fallback rules of
    :func:`_dhd_competition`.
    """

    def __init__(
        self,
        regions: Sequence[OverlapRegion],
        g: Graph,
        candidates: List[Tuple[int, np.ndarray, List[np.ndarray]]],
        params: dhd.DHDParams,
        n_steps: int,
        device: DeviceLike = None,
    ) -> None:
        self.candidates = candidates
        self.n_regions = len(regions)
        self.heat, self.valid = self._build(
            regions, g, candidates, params, n_steps, device=device
        )

    @staticmethod
    def _build(
        regions: Sequence[OverlapRegion],
        g: Graph,
        candidates: List[Tuple[int, np.ndarray, List[np.ndarray]]],
        params: dhd.DHDParams,
        n_steps: int,
        device: DeviceLike = None,
    ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        reg = get_registry()
        if not reg.enabled:
            return CompetitionArena._build_impl(
                regions, g, candidates, params, n_steps, device
            )
        t0 = time.perf_counter()
        out = CompetitionArena._build_impl(
            regions, g, candidates, params, n_steps, device
        )
        reg.histogram("placement.arena_build_s").observe(time.perf_counter() - t0)
        reg.counter("placement.arena_builds").inc()
        reg.counter("placement.diffusion_candidates").inc(len(candidates))
        return out

    @staticmethod
    def _build_impl(
        regions: Sequence[OverlapRegion],
        g: Graph,
        candidates: List[Tuple[int, np.ndarray, List[np.ndarray]]],
        params: dhd.DHDParams,
        n_steps: int,
        device: DeviceLike = None,
    ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        n_regions = len(regions)
        n_cand = len(candidates)
        valid = np.zeros(n_cand, dtype=bool)
        rsrc, rdst, rw = region_adjacency(regions, g)
        if len(rsrc) == 0:  # heat cannot reach anything -> frequency fallback
            return None, valid
        item_region = np.full(g.n_items, -1, dtype=np.int64)
        for r in regions:
            item_region[r.items] = r.rid
        src_reg = item_region[g.src]
        dst_reg = item_region[g.dst]
        # super-node edge weights per candidate: graph-edge counts between
        # the candidate's holdings and each region (Fig. 4b), segment-summed
        cnt = np.zeros((n_cand, n_regions), dtype=np.float32)
        held_mask = np.zeros(g.n_items, dtype=bool)
        for ci, (_, _, held_items) in enumerate(candidates):
            if not held_items:
                continue
            held = np.concatenate(held_items)
            if len(held) == 0:
                continue
            held_mask[:] = False
            held_mask[held] = True
            touch_src = held_mask[g.src] & (dst_reg >= 0)
            touch_dst = held_mask[g.dst] & (src_reg >= 0)
            np.add.at(cnt[ci], dst_reg[touch_src], 1.0)
            np.add.at(cnt[ci], src_reg[touch_dst], 1.0)
            valid[ci] = bool(cnt[ci].any())
        if not valid.any():
            return None, valid
        # shared edge-list union: region edges + every super edge any
        # candidate uses; per-candidate weights switch its own super edges on
        touched = np.where(cnt.any(axis=0))[0]
        usrc = np.concatenate([rsrc, np.full(len(touched), n_regions, dtype=np.int64)])
        udst = np.concatenate([rdst, touched])
        weights = np.empty((n_cand, len(usrc)), dtype=np.float32)
        weights[:, : len(rw)] = rw[None, :]
        weights[:, len(rw):] = cnt[:, touched]
        seeds = np.zeros((n_cand, n_regions + 1), dtype=np.float32)
        seeds[:, n_regions] = 1.0
        heat = dhd.diffuse_affinity_batch(
            n_regions + 1, usrc, udst, weights, seeds,
            params=params, n_steps=n_steps, device=device,
        )
        return heat, valid

    def winner(self, rid: int, req: Sequence[int], unit_r: np.ndarray) -> int:
        """Winning position within ``req`` (candidate indices contesting
        region ``rid``) — same scoring and frequency fallback as
        :func:`_dhd_competition` over the same candidate order."""
        if self.heat is not None:
            scores = np.asarray(
                [self.heat[i, rid] if self.valid[i] else -1.0 for i in req]
            )
            if scores.max() > 0:
                return int(scores.argmax())
        freq = [float(unit_r[self.candidates[i][1]].sum()) for i in req]
        return int(np.asarray(freq).argmax())


# ------------------------------------------------------- main placement flow
def overlap_centric_placement(
    lg: LayeredGraph,
    workload: Workload,
    config: Optional[PlacementConfig] = None,
    device: DeviceLike = None,
) -> Tuple[PlacementState, Dict[str, object]]:
    """Algorithms 1 + 2 end-to-end.  Returns (placement state, stats);
    ``device`` is where the DHD diffusions run."""
    cfg = config or PlacementConfig()
    g, env = lg.g, lg.env
    sizes = g.item_size()
    D = env.n_dcs
    state = PlacementState.empty(g.n_items, D)

    # primary copies: each vertex at its partition DC, each edge at src's DC
    state.delta[np.arange(g.n_nodes), g.partition] = True
    state.delta[g.n_nodes + np.arange(g.n_edges), g.partition[g.src]] = True
    primary = np.concatenate([g.partition, g.partition[g.src]]).astype(np.int64)

    # holdings[k][id] -> list of units.  At k>0 id = bs_id; at k=0 id = dc.
    h = lg.n_layers
    holdings: List[Dict[int, List[PlacedUnit]]] = [dict() for _ in range(h + 1)]
    pools: List[Dict[int, List[Tuple[int, PlacedUnit]]]] = [dict() for _ in range(h + 1)]
    stats = dict(replicated=0, decomposed=0, regions=0, competitions=0, skipped_w=0)

    def requesting_dcs(unit: PlacedUnit, dcs: np.ndarray) -> np.ndarray:
        return dcs[unit.r_py[dcs] > 0]

    # ---- Alg. 1: sink each pattern to its target layer -------------------
    for p in workload.patterns:
        if p.read_rate <= p.write_rate:  # Alg. 2 precondition R > W
            stats["skipped_w"] += 1
            continue
        unit = PlacedUnit.from_pattern(p)
        k_star = lg.layer_for_latency(p.eta * cfg.gamma_max_s)
        placed = False
        for b in lg.layers[k_star]:
            if len(requesting_dcs(unit, b.dcs)):
                holdings[k_star].setdefault(b.bs_id, []).append(unit)
                placed = True
        if not placed:  # requesting DC isolated at this layer -> direct deposit
            for dc in np.where(p.r_py > 0)[0]:
                holdings[0].setdefault(int(dc), []).append(unit)

    # ---- Alg. 2: layer-by-layer placement --------------------------------
    for k in range(h, 0, -1):
        # Phase 1: replication-vs-decomposition per held unit
        for bs_id, units in list(holdings[k].items()):
            b = lg.bs(bs_id)
            children = lg.bs_children(b)
            for unit in units:
                if k == 1 or not children:
                    # children are the DCs of this BS's cluster
                    child_dcs = [np.asarray([int(d)]) for d in b.dcs
                                 if unit.r_py[int(d)] > 0]
                    child_ids = [int(d) for d in b.dcs if unit.r_py[int(d)] > 0]
                    to_layer = 0
                else:
                    kids = [c for c in children if len(requesting_dcs(unit, c.dcs))]
                    child_dcs = [c.dcs for c in kids]
                    child_ids = [c.bs_id for c in kids]
                    to_layer = k - 1
                if not child_ids:
                    continue
                gain = replication_gain(
                    unit, b.dcs, child_dcs, sizes, env, cfg.lambda1, primary
                )
                if gain >= 0:
                    stats["replicated"] += 1
                    for cid in child_ids:
                        holdings[to_layer].setdefault(cid, []).append(unit)
                else:
                    stats["decomposed"] += 1
                    pools[k].setdefault(b.comp, []).append((bs_id, unit))
        holdings[k].clear()

        # Phase 2: overlap-region allocation within each cluster
        for comp, entries in list(pools[k].items()):
            units = [u for (_, u) in entries]
            pseudo = [
                Pattern(pid=i, items=u.items, r_py=u.r_py, w_py=u.w_py, eta=u.eta)
                for i, u in enumerate(units)
            ]
            regions = decompose_overlap_regions(pseudo, g.n_items)
            stats["regions"] += len(regions)
            b_holder = next(bb for bb in lg.layers[k] if bb.comp == comp)
            children = lg.bs_children(b_holder)
            if k == 1 or not children:
                cand = [
                    (int(d), np.asarray([int(d)]), [u.items for u in holdings[0].get(int(d), [])])
                    for d in b_holder.dcs
                ]
                to_layer = 0
            else:
                cand = [
                    (c.bs_id, c.dcs, [u.items for u in holdings[k - 1].get(c.bs_id, [])])
                    for c in children
                ]
                to_layer = k - 1
            # one batched diffusion covers every competition in this pool;
            # built lazily so pools that fully replicate never pay for it
            arena: Optional[CompetitionArena] = None

            def _get_arena() -> CompetitionArena:
                nonlocal arena
                if arena is None:
                    arena = CompetitionArena(
                        regions, g, cand, cfg.dhd, cfg.dhd_steps, device=device
                    )
                return arena

            for region in regions:
                pids = region.key
                r_py = np.sum([units[i].r_py for i in pids], axis=0)
                w_py = np.sum([units[i].w_py for i in pids], axis=0)
                runit = PlacedUnit(
                    items=region.items, r_py=r_py, w_py=w_py,
                    eta=min(units[i].eta for i in pids),
                    key=tuple(sorted(set(sum((units[i].key for i in pids), ())))),
                )
                req_idx = [
                    i for i, (cid, dcs, held) in enumerate(cand)
                    if r_py[dcs].sum() > 0
                ]
                if not req_idx:
                    continue
                req = [cand[i] for i in req_idx]
                gain = replication_gain(
                    runit, b_holder.dcs, [d for (_, d, _) in req], sizes, env,
                    cfg.lambda1, primary,
                )
                if gain > 0:
                    stats["replicated"] += 1
                    targets = [cid for (cid, _, _) in req]
                else:
                    stats["competitions"] += 1
                    if cfg.dhd_batch:
                        win = _get_arena().winner(region.rid, req_idx, r_py)
                    else:
                        win = _dhd_competition(
                            region, req, regions, g, cfg.dhd, cfg.dhd_steps, r_py,
                            device=device,
                        )
                    targets = [req[win][0]]
                for cid in targets:
                    holdings[to_layer].setdefault(cid, []).append(runit)
            pools[k].pop(comp)

    # ---- deposit layer-0 holdings as replicas -----------------------------
    for dc, units in holdings[0].items():
        for u in units:
            state.delta[u.items, int(dc)] = True

    # ---- Phase 3: pre-caching (paper §V) ----------------------------------
    if cfg.precache:
        precache_hot_regions(
            g, workload, state, cfg.theta_quantile, cfg.dhd,
            max_per_dc=cfg.precache_max_per_dc, device=device,
        )

    state.route_nearest(env)
    return state, stats


# ----------------------------------------------------------------- pre-cache
def precache_hot_regions(
    g: Graph,
    workload: Workload,
    state: PlacementState,
    theta_quantile: float = 0.55,
    params: dhd.DHDParams = dhd.DHDParams(),
    n_steps: int = 48,
    max_per_dc: int = 4096,
    read_intensity: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Steady-state DHD over the whole graph; cache vertices whose equilibrium
    heat is >= the ``theta_quantile`` of the heat distribution at every DC
    that does not own them (bounded by ``max_per_dc``).  Returns hot-vertex ids.

    ``read_intensity`` injects the ``[n_items]`` per-item demand the DHD
    seeds/edge weights derive from — a measured or *forecast* view from the
    demand plane (``ODDemandLayer.measured()/forecast().item_heat``).  The
    default reads the static workload tables, which is bit-identical to the
    pre-demand-plane behavior.
    """
    if read_intensity is None:
        r_v = workload.r_xy[: g.n_nodes].sum(axis=1).astype(np.float32)
        w_raw = workload.r_xy[g.n_nodes :].sum(axis=1).astype(np.float32)
    else:
        ri = np.asarray(read_intensity, dtype=np.float32)
        r_v = ri[: g.n_nodes]
        w_raw = ri[g.n_nodes :]
    if r_v.max() <= 0:
        return np.zeros(0, dtype=np.int64)
    heat0 = r_v / r_v.max()
    theta = float(np.quantile(heat0[heat0 > 0], theta_quantile)) if (heat0 > 0).any() else 0.0
    sources = heat0 >= theta
    q0 = np.where(sources, 1.0 / max(sources.sum(), 1), 0.0).astype(np.float32)
    w_e = w_raw / max(w_raw.max(), 1.0) + 1e-3
    heat = dhd.diffuse_affinity_batch(
        g.n_nodes, g.src, g.dst, w_e, q0[None, :], base_heat=heat0,
        params=params, n_steps=n_steps, device=device,
    )[0]
    theta_star = float(np.quantile(heat, theta_quantile))
    hot = np.where(heat >= theta_star)[0]
    if len(hot) > max_per_dc:
        hot = hot[np.argsort(-heat[hot])[:max_per_dc]]
    for d in range(state.delta.shape[1]):
        ext = hot[g.partition[hot] != d]
        state.delta[ext, d] = True
    return hot


# ------------------------------------------------------------------ eviction
class HeatCache:
    """Online replica eviction (Alg. 3): heat-tracked cache per DC.

    The cache does not own its heat array: ``heat`` is a shared-storage row
    view into the store's :class:`~repro_torch.demand.ODDemandLayer` (the single
    owner of online request heat).  Standalone construction (tests, ad-hoc
    use) gets a private single-row demand layer, so the Alg. 3 semantics are
    identical either way — accumulate via ``observe``, diffuse via ``step``,
    evict below ``theta_c``."""

    def __init__(
        self,
        g: Graph,
        dc: int,
        state: PlacementState,
        params: dhd.DHDParams = dhd.DHDParams(),
        theta_c: float = 0.05,
        demand=None,
        device: DeviceLike = None,
    ) -> None:
        self.g = g
        self.dc = dc
        self.state = state
        self.params = params
        self.theta_c = theta_c
        self.device = device  # where step() diffuses
        if demand is None:
            # standalone cache: private single-row demand layer (row 0)
            from ..demand import ODDemandLayer

            demand = ODDemandLayer(g.n_items, 1)
            self._row = 0
        else:
            self._row = dc
        self.demand = demand
        # streaming stores set this to the alive mask so diffusion never
        # crosses tombstoned edges; None = static graph, all edges live
        self.edge_mask: Optional[np.ndarray] = None

    @property
    def heat(self) -> np.ndarray:
        """This DC's row of the demand plane's ``[D, n_items]`` heat table —
        a view, not a copy: in-place mutation (diffusion, decay) writes
        through, and there is no second array to fall out of sync."""
        return self.demand.heat[self._row]

    def cached_mask(self) -> np.ndarray:
        """Replicas held at this DC beyond the primary partition copy."""
        primary = np.zeros(self.g.n_items, dtype=bool)
        primary[: self.g.n_nodes] = self.g.partition == self.dc
        primary[self.g.n_nodes :] = self.g.partition[self.g.src] == self.dc
        return self.state.delta[:, self.dc] & ~primary

    def observe(self, item_ids: np.ndarray, freq: float = 1.0) -> None:
        """External heat injection: one access event batch (Alg. 3 lines 3-5).

        Delegates to the demand plane — the one place accumulation happens —
        where duplicate ids accumulate (``serve_batch`` concatenates
        per-origin request items), which fancy-index ``+=`` would silently
        collapse."""
        self.demand.observe(item_ids, origin=self._row, freq=freq)

    def step(self, n_steps: int = 4) -> None:
        """Diffuse heat over the cache topology (vertex items only)."""
        step_heat_caches([self], n_steps=n_steps)

    def evict(self) -> np.ndarray:
        """Remove cold replicas; returns evicted item ids (Alg. 3 lines 7-10).

        The caller (``GeoGraphStore.maintain``) refreshes the routing table
        after eviction, matching Alg. 3 line 10."""
        cold = self.cached_mask() & (self.heat < self.theta_c)
        ids = np.where(cold)[0]
        self.state.delta[ids, self.dc] = False
        return ids


def step_heat_caches(caches: Sequence[HeatCache], n_steps: int = 4) -> None:
    """Diffuse every cache's heat field in ONE batched DHD run.

    All per-DC caches of a store share the same graph, edge mask and params,
    so their Alg. 3 diffusions differ only in the seed heat — a ``[D, n]``
    batch through :func:`repro_torch.core.dhd.diffuse_affinity_batch`.  Caches
    with differing topology fall back to individual runs.  Row ``d`` equals
    what ``caches[d].step(n_steps)`` alone would produce."""
    if not caches:
        return
    lead = caches[0]
    shared = all(
        c.g is lead.g and c.edge_mask is lead.edge_mask
        and c.params == lead.params and c.device == lead.device
        for c in caches[1:]
    )
    if not shared:
        for c in caches:
            step_heat_caches([c], n_steps=n_steps)
        return
    g = lead.g
    if lead.edge_mask is not None:
        src, dst = g.src[lead.edge_mask], g.dst[lead.edge_mask]
    else:
        src, dst = g.src, g.dst
    n = g.n_nodes
    seeds = np.stack([c.heat[:n] for c in caches])
    h = dhd.diffuse_affinity_batch(
        n, src, dst, np.ones(len(src), dtype=np.float32), seeds,
        params=lead.params, n_steps=n_steps, device=lead.device,
    )
    decay = (1.0 - lead.params.gamma) ** n_steps
    # heat is single-owned by the demand layer: diffusion results go back
    # through its write-back, never through the HeatCache.heat view (GL003)
    for c, row in zip(caches, h):
        c.demand.apply_diffusion(c._row, row, decay)
