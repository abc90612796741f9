"""Competitor replica-placement / routing / layout strategies (paper §VII-A).

Online-mode competitors (vs overlap-centric placement + stepwise routing):
  * Random-3 — replicas at 3 random DCs, random routing.
  * Top-3    — replicas at the 3 highest-read-frequency DCs, random routing.
  * ADP      — hypergraph-partitioning placement (Yu & Pan [28]): patterns are
               hyperedges; greedy balanced min-cut assignment of items to DCs.
  * DCD      — overlapping-community placement (Liu et al. [27]): communities
               of the co-access graph replicated to their top requesting DCs.
ADP/DCD route with greedy set cover (their papers' routing).

Offline-mode competitors (vs stepwise offline routing):
  * RAGraph  — primary partition in place (no migration).
  * RAGraph+ — contribution-driven edge migration.
  * GrapH    — heterogeneity-aware adaptive edge migration (vertex traffic).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .cost import PlacementState
from .graph import Graph
from .latency import GeoEnvironment
from .patterns import Workload

__all__ = [
    "place_random_k",
    "place_top_k",
    "place_adp",
    "place_dcd",
    "route_random",
    "route_greedy_set_cover",
    "layout_ragraph",
    "layout_ragraph_plus",
    "layout_graph_h",
]


def _primary_state(g: Graph, n_dcs: int) -> PlacementState:
    state = PlacementState.empty(g.n_items, n_dcs)
    state.delta[np.arange(g.n_nodes), g.partition] = True
    state.delta[g.n_nodes + np.arange(g.n_edges), g.partition[g.src]] = True
    return state


# ----------------------------------------------------------------- placement
def place_random_k(
    g: Graph, workload: Workload, env: GeoEnvironment, k: int = 3, seed: int = 0
) -> PlacementState:
    rng = np.random.default_rng(seed)
    state = _primary_state(g, env.n_dcs)
    accessed = np.where(workload.r_xy.sum(axis=1) > 0)[0]
    for x in accessed:
        for d in rng.choice(env.n_dcs, size=min(k, env.n_dcs), replace=False):
            state.delta[x, d] = True
    return state


def place_top_k(
    g: Graph, workload: Workload, env: GeoEnvironment, k: int = 3
) -> PlacementState:
    state = _primary_state(g, env.n_dcs)
    accessed = np.where(workload.r_xy.sum(axis=1) > 0)[0]
    order = np.argsort(-workload.r_xy[accessed], axis=1)[:, :k]
    for row, x in enumerate(accessed):
        for d in order[row]:
            if workload.r_xy[x, d] > 0:
                state.delta[x, d] = True
    return state


def place_adp(
    g: Graph, workload: Workload, env: GeoEnvironment, n_rounds: int = 3
) -> PlacementState:
    """Hypergraph-partitioning placement.  Items = vertices, patterns =
    hyperedges; greedy FM-style passes move items between DCs to reduce the
    number of DCs spanned per hyperedge, weighted by pattern frequency,
    under a soft balance constraint.  Each item's part = its replica site.
    """
    D = env.n_dcs
    state = _primary_state(g, env.n_dcs)
    # initial part = DC with max read frequency (frequency-aware seeding)
    accessed = np.where(workload.r_xy.sum(axis=1) > 0)[0]
    part = np.full(g.n_items, -1, dtype=np.int64)
    part[accessed] = np.argmax(workload.r_xy[accessed], axis=1)
    item_patterns: Dict[int, List[int]] = {}
    for pi, p in enumerate(workload.patterns):
        for x in p.items.tolist():
            item_patterns.setdefault(x, []).append(pi)
    cap = max(1, int(1.2 * len(accessed) / D))
    loads = np.bincount(part[accessed], minlength=D)
    for _ in range(n_rounds):
        moved = 0
        for x in accessed.tolist():
            pis = item_patterns.get(x, [])
            if not pis:
                continue
            # score each DC by co-located pattern mass
            score = np.zeros(D)
            for pi in pis:
                p = workload.patterns[pi]
                counts = np.bincount(
                    part[p.items][part[p.items] >= 0], minlength=D
                ).astype(np.float64)
                score += p.read_rate * counts
            score[loads >= cap] = -np.inf
            best = int(score.argmax())
            if best != part[x] and np.isfinite(score[best]):
                loads[part[x]] -= 1
                loads[best] += 1
                part[x] = best
                moved += 1
        if moved == 0:
            break
    for x in accessed:
        state.delta[x, part[x]] = True
    return state


def place_dcd(
    g: Graph, workload: Workload, env: GeoEnvironment, k_rep: int = 2
) -> PlacementState:
    """Overlapping-community placement: communities = pattern item sets merged
    by Jaccard overlap; each community replicated at its top-k requesting DCs.
    """
    state = _primary_state(g, env.n_dcs)
    pats = workload.patterns
    n = len(pats)
    parent = list(range(n))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    sets = [set(p.items.tolist()) for p in pats]
    for i in range(n):
        for j in range(i + 1, min(i + 30, n)):  # windowed pairing for scale
            inter = len(sets[i] & sets[j])
            if inter == 0:
                continue
            jac = inter / len(sets[i] | sets[j])
            if jac > 0.2:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)
    comms: Dict[int, List[int]] = {}
    for i in range(n):
        comms.setdefault(find(i), []).append(i)
    for members in comms.values():
        items = np.unique(np.concatenate([pats[i].items for i in members]))
        r = np.sum([pats[i].r_py for i in members], axis=0)
        top = np.argsort(-r)[:k_rep]
        for d in top:
            if r[d] > 0:
                state.delta[items, int(d)] = True
    return state


# ------------------------------------------------------------------- routing
def route_random(
    state: PlacementState, workload: Workload, env: GeoEnvironment, seed: int = 0
) -> None:
    """Random routing: each (item, origin) picks a uniform random replica."""
    rng = np.random.default_rng(seed)
    I, D = state.delta.shape
    state.route = np.full((I, D), -1, dtype=np.int32)
    holders = [np.where(state.delta[x])[0] for x in range(I)]
    for x in range(I):
        h = holders[x]
        if len(h) == 0:
            continue
        state.route[x] = h[rng.integers(0, len(h), size=D)]


def route_greedy_set_cover(
    state: PlacementState, workload: Workload, env: GeoEnvironment
) -> None:
    """ADP/DCD routing: per (pattern, origin) greedy set cover over DCs,
    preferring DCs that serve the most still-missing items (min #DCs)."""
    I, D = state.delta.shape
    state.route = np.full((I, D), -1, dtype=np.int32)
    # default: nearest replica for items not covered by pattern routing
    lat = env.rtt_s.copy()
    np.fill_diagonal(lat, 0.0)
    big = np.where(state.delta[:, :, None], lat[None, :, :], np.inf)
    nearest = np.argmin(big, axis=1).astype(np.int32)
    placed = state.delta.any(axis=1)
    state.route[placed] = nearest[placed]
    for p in workload.patterns:
        for y in np.where(p.r_py > 0)[0]:
            served = np.zeros(len(p.items), dtype=bool)
            while not served.all():
                cover = state.delta[p.items[~served]].sum(axis=0)
                d = int(cover.argmax())
                if cover[d] == 0:
                    break
                hit = ~served & state.delta[p.items, d]
                state.route[p.items[hit], y] = d
                served |= hit


# ----------------------------------------------------------- offline layouts
def layout_ragraph(g: Graph, env: GeoEnvironment) -> np.ndarray:
    """RAGraph default: vertices execute at their primary partition."""
    return g.partition.astype(np.int64).copy()


def layout_ragraph_plus(
    g: Graph,
    env: GeoEnvironment,
    traffic: Optional[np.ndarray] = None,
    budget_frac: float = 0.15,
) -> np.ndarray:
    """Contribution-driven edge migration: move the highest-traffic boundary
    vertices to the neighbor DC that removes the most cut edges."""
    site = g.partition.astype(np.int64).copy()
    t = traffic if traffic is not None else np.ones(g.n_nodes)
    budget = int(budget_frac * g.n_nodes)
    cross = site[g.src] != site[g.dst]
    cand = np.unique(np.concatenate([g.src[cross], g.dst[cross]]))
    cand = cand[np.argsort(-t[cand])][:budget]
    # neighbor DC histogram per candidate
    for v in cand.tolist():
        m_out = g.src == v
        m_in = g.dst == v
        nb_dc = np.concatenate([site[g.dst[m_out]], site[g.src[m_in]]])
        if len(nb_dc) == 0:
            continue
        counts = np.bincount(nb_dc, minlength=env.n_dcs)
        best = int(counts.argmax())
        if counts[best] > counts[site[v]]:
            site[v] = best
    return site


def layout_graph_h(
    g: Graph,
    env: GeoEnvironment,
    traffic: Optional[np.ndarray] = None,
    budget_frac: float = 0.15,
) -> np.ndarray:
    """GrapH-style: migration gain weighs vertex traffic by link $/byte —
    prefers moving hot vertices off expensive heterogeneous paths."""
    site = g.partition.astype(np.int64).copy()
    t = traffic if traffic is not None else np.ones(g.n_nodes)
    budget = int(budget_frac * g.n_nodes)
    cross = site[g.src] != site[g.dst]
    cand = np.unique(np.concatenate([g.src[cross], g.dst[cross]]))
    # expensive-path traffic first
    def path_cost(v: int) -> float:
        m_out = g.src == v
        m_in = g.dst == v
        nb = np.concatenate([site[g.dst[m_out]], site[g.src[m_in]]])
        if len(nb) == 0:
            return 0.0
        return float(t[v] * env.c_net[site[v], nb].sum())

    scores = np.array([path_cost(int(v)) for v in cand])
    cand = cand[np.argsort(-scores)][:budget]
    for v in cand.tolist():
        m_out = g.src == v
        m_in = g.dst == v
        nb_dc = np.concatenate([site[g.dst[m_out]], site[g.src[m_in]]])
        if len(nb_dc) == 0:
            continue
        gains = np.zeros(env.n_dcs)
        for d in range(env.n_dcs):
            gains[d] = -env.c_net[d, nb_dc].sum() * t[v]
        best = int(gains.argmax())
        if gains[best] > gains[site[v]]:
            site[v] = best
    return site
