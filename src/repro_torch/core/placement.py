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
import hashlib
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
    "PlacementJournal",
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
        heat_valid: Optional[Tuple[Optional[np.ndarray], np.ndarray]] = None,
    ) -> None:
        self.candidates = candidates
        self.n_regions = len(regions)
        if heat_valid is None:
            heat_valid = self._build(regions, g, candidates, params, n_steps, device)
        self.heat, self.valid = heat_valid

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


# ------------------------------------------------------- placement journal
def _digest(*arrays: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        b = np.ascontiguousarray(a)
        h.update(str(b.dtype).encode())
        h.update(str(b.shape).encode())
        h.update(b.tobytes())
    return h.digest()


def _unit_fp(u: PlacedUnit, uid: Optional[np.ndarray] = None) -> Tuple:
    items = uid[u.items] if uid is not None else u.items
    return (u.key, float(u.eta), _digest(items, u.r_py, u.w_py))


def _cand_fp(
    cand: List[Tuple[int, np.ndarray, List[np.ndarray]]],
    uid: Optional[np.ndarray] = None,
) -> Tuple:
    return tuple(
        (cid, _digest(dcs),
         tuple(_digest(uid[h] if uid is not None else h) for h in held))
        for (cid, dcs, held) in cand
    )


class PlacementJournal:
    """Memo of placement intermediates keyed on their *exact* inputs.

    Algorithms 1+2 are deterministic, so any intermediate whose inputs are
    unchanged between two runs can be replayed from the journal instead of
    recomputed.  :meth:`GeoGraphStore.insert_patterns_incremental` exploits
    this: re-running placement over the extended workload only pays for the
    pools the new patterns actually touch (decomposition, region adjacency
    and the batched DHD heat table are all journal hits elsewhere), which is
    what makes the result provably identical to a full re-place.

    Keys fingerprint unit items/frequencies and candidate holdings with
    BLAKE2 digests.  When ``item_uid`` is set (the store maintains one
    monotonically-assigned uid per item row), digests run over *uids* rather
    than raw row indices — raw rows renumber on compaction, uids never do —
    which makes every key **fingerprint-stable across**
    ``GeoGraphStore._compact_in_place``: the store calls :meth:`remap` to
    rewrite the row-indexed memo *values* (region item arrays) onto the
    compacted id space and every key keeps matching.  Topology changes
    (mutation batches) still discard the journal: region adjacency and heat
    tables depend on the edge set itself, not just the pool's items.  Each
    memo table is FIFO-bounded (``max_entries``) so repeated incremental
    inserts — which retire old fingerprints every round — cannot grow it
    without bound; evicted entries simply recompute on next use.
    """

    def __init__(self, max_entries: int = 4096) -> None:
        self.max_entries = max_entries
        self.regions: Dict[Tuple, List[OverlapRegion]] = {}
        self.heat: Dict[Tuple, Tuple[Optional[np.ndarray], np.ndarray]] = {}
        self.gain: Dict[Tuple, float] = {}
        self.hits = 0
        self.misses = 0
        # [n_items] content-stable uid per item row; owned by the store
        self.item_uid: Optional[np.ndarray] = None

    def stats(self) -> Dict[str, int]:
        return dict(hits=self.hits, misses=self.misses,
                    pools=len(self.regions), heats=len(self.heat))

    def unit_fp(self, u: PlacedUnit) -> Tuple:
        return _unit_fp(u, self.item_uid)

    def cand_fp(self, cand: List[Tuple[int, np.ndarray, List[np.ndarray]]]) -> Tuple:
        return _cand_fp(cand, self.item_uid)

    def remap(self, imap: np.ndarray, item_uid: np.ndarray) -> None:
        """Re-key row-indexed memo values onto a compacted id space.

        ``imap[old_row] -> new_row`` (-1 = dropped).  Keys are uid-digests
        and survive untouched; only region item arrays store raw rows
        (compaction renumbers monotonically, so remapped arrays stay sorted
        — the decompose invariant).  Gains are scalars over sizes/prices
        that compaction preserves and survive too.  Heat tables do NOT:
        ``region_adjacency`` runs over the raw edge arrays, which before
        compaction still contain tombstoned edges — a post-compaction
        recompute would exclude them, so memoized tables are cleared rather
        than replayed stale."""
        for regions in self.regions.values():
            for r in regions:
                it = imap[r.items]
                r.items = it[it >= 0]
        self.heat.clear()
        self.item_uid = item_uid

    def memo(self, cache: Dict, key: Tuple, compute):
        hit = cache.get(key)
        if hit is not None:
            self.hits += 1
            return hit
        self.misses += 1
        out = compute()
        cache[key] = out
        while len(cache) > self.max_entries:  # FIFO: dicts keep insert order
            cache.pop(next(iter(cache)))
        return out


# ------------------------------------------------------- main placement flow
def overlap_centric_placement(
    lg: LayeredGraph,
    workload: Workload,
    config: Optional[PlacementConfig] = None,
    device: DeviceLike = None,
    journal: Optional[PlacementJournal] = None,
    route: bool = True,
) -> Tuple[PlacementState, Dict[str, object]]:
    """Algorithms 1 + 2 end-to-end.  Returns (placement state, stats);
    ``device`` is where the DHD diffusions run.

    ``journal`` memoizes pool decompositions, replication gains and DHD heat
    tables across runs (see :class:`PlacementJournal`); ``route=False`` skips
    the final nearest-replica table derivation for callers that patch an
    existing :class:`~repro_torch.core.route_index.RouteIndex` instead."""
    cfg = config or PlacementConfig()
    g, env = lg.g, lg.env
    sizes = g.item_size()
    D = env.n_dcs
    state = PlacementState.empty(g.n_items, D)
    # journal counters persist across placements; track this run's delta
    j_hits0 = journal.hits if journal is not None else 0
    j_miss0 = journal.misses if journal is not None else 0

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
                if journal is not None:
                    gkey = (journal.unit_fp(unit), bs_id, tuple(child_ids), to_layer)
                    gain = journal.memo(
                        journal.gain, gkey,
                        lambda: replication_gain(
                            unit, b.dcs, child_dcs, sizes, env, cfg.lambda1, primary
                        ),
                    )
                else:
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
            pool_fp = (
                (k, comp, tuple((bs, journal.unit_fp(u)) for (bs, u) in entries))
                if journal is not None else None
            )
            def _decompose():
                pseudo = [
                    Pattern(pid=i, items=u.items, r_py=u.r_py, w_py=u.w_py, eta=u.eta)
                    for i, u in enumerate(units)
                ]
                return decompose_overlap_regions(pseudo, g.n_items)
            if journal is not None:
                regions = journal.memo(journal.regions, pool_fp, _decompose)
            else:
                regions = _decompose()
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
                    hv = None
                    if journal is not None:
                        hv = journal.memo(
                            journal.heat, (pool_fp, journal.cand_fp(cand)),
                            lambda: CompetitionArena._build(
                                regions, g, cand, cfg.dhd, cfg.dhd_steps, device
                            ),
                        )
                    arena = CompetitionArena(
                        regions, g, cand, cfg.dhd, cfg.dhd_steps, device=device,
                        heat_valid=hv,
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
                if journal is not None:
                    gkey = (
                        journal.unit_fp(runit), b_holder.bs_id,
                        tuple(cand[i][0] for i in req_idx), to_layer,
                    )
                    gain = journal.memo(
                        journal.gain, gkey,
                        lambda: replication_gain(
                            runit, b_holder.dcs, [d for (_, d, _) in req],
                            sizes, env, cfg.lambda1, primary,
                        ),
                    )
                else:
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

    if journal is not None:
        stats["journal"] = journal.stats()
        reg = get_registry()
        if reg.enabled:
            reg.counter("placement.journal_hits").inc(journal.hits - j_hits0)
            reg.counter("placement.journal_misses").inc(journal.misses - j_miss0)
    if route:
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
