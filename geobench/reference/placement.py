"""GeoLayer's replica placement at build time, written for the reference.

Plain NumPy from the paper's algorithms, on the CPU, with nothing of the
port: the latency-aware layered graph (§IV, Defs. 1-2), the sink of each
pattern to the layer of its latency bound (Alg. 1), the layer-by-layer
choice between replicating a unit into every requesting child and
splitting it into overlap regions (Alg. 2, the Eq. 13 surrogate gain), the
overlap regions' competition by directed heat diffusion over the region
graph (Fig. 4, Eqs. 7-10), and the pre-caching of hot vertices (§V).

The store keeps heat in float32, so every heat field here is float32; its
sums of item bytes are float32 sums of its float32 sizes, and its
frequencies and prices float64.  A step of the diffusion works over an
undirected edge list: on each edge of positive weight whose ends differ in
heat, the hotter end sends ``alpha * w / n_out * (H_hot - H_cold)`` to the
colder, ``n_out`` counting the hotter end's such edges; then
``H' = (1 - gamma) * (H + inflow - outflow) + beta * Q``, the sources
decaying with a half-life of a quarter of the steps.

:func:`place` returns the replica sets, ``[items, DCs]`` booleans.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PlacementParams", "layered_graph", "diffuse", "overlap_regions",
           "region_edges", "replication_gain", "precache", "place"]


@dataclasses.dataclass
class PlacementParams:
    """The store's defaults: a 500-ms latency bound, Eq. 13's lambda1,
    the paper's DHD constants, 32 competition steps, pre-caching at the
    0.55 heat quantile, at most 4,096 vertices a DC."""

    gamma_max_s: float = 0.5
    lambda1: float = 0.5
    alpha: float = 0.5
    gamma: float = 0.1
    beta: float = 0.3
    dhd_steps: int = 32
    precache_steps: int = 48
    theta_quantile: float = 0.55
    precache_max_per_dc: int = 4096
    interval_s: float = 0.100
    # rounds each diffusion step's heat (the control's lower precision)
    round_step: Optional[Callable[[np.ndarray], np.ndarray]] = None


# ------------------------------------------------------------ layered graph
@dataclasses.dataclass
class Bridge:
    """A bridge subgraph: the component ``comp`` of layer ``layer``, which
    merges the components ``children`` of the layer below and spans the
    DCs ``dcs``."""

    bid: int
    layer: int
    comp: int
    children: List[int]
    dcs: np.ndarray


@dataclasses.dataclass
class Layers:
    h: int
    thresholds: List[float]
    comp: np.ndarray  # [h + 1, D] component of each DC at each layer
    bridges: List[List[Bridge]]  # bridges[k], in component order

    def layer_for(self, latency_s: float) -> int:
        """The layer whose latency interval holds ``latency_s``."""
        return min(self.h, 1 + sum(1 for t in self.thresholds if latency_s >= t))

    def children(self, b: Bridge) -> List[Bridge]:
        if b.layer <= 1:
            return []
        return [c for cc in b.children for c in self.bridges[b.layer - 1] if c.comp == cc]


def _label_components(n: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Components of ``n`` nodes joined by pairs ``(a, b)``, numbered by
    their smallest member."""
    root = list(range(n))

    def find(x: int) -> int:
        while root[x] != x:
            x = root[x]
        return x

    for u, v in zip(a.tolist(), b.tolist()):
        ru, rv = find(u), find(v)
        if ru != rv:
            root[max(ru, rv)] = min(ru, rv)
    roots = [find(x) for x in range(n)]
    first = {r: i for i, r in enumerate(sorted(set(roots)))}
    return np.array([first[r] for r in roots], np.int64)


def layered_graph(g, env, interval_s: float = 0.100) -> Layers:
    """Def. 1: a cross-DC edge lies in the layer of its DCs' RTT, in
    ``interval_s`` steps.  Def. 2: at each layer the edges join the
    components of the layer below; each new component that a layer edge
    touches is a bridge subgraph."""
    D = env.n_dcs
    h = max(1, int(np.ceil(float(env.rtt_s.max()) / interval_s + 1e-9)))
    thresholds = [interval_s * k for k in range(1, h)]
    a = g.partition[g.src].astype(np.int64)
    b = g.partition[g.dst].astype(np.int64)
    t = np.asarray([0.0] + thresholds + [np.inf])
    layer = np.clip(np.searchsorted(t, env.rtt_s[a, b], side="right"), 1, h)
    layer[a == b] = 0
    comp = np.zeros((h + 1, D), np.int64)
    comp[0] = np.arange(D)
    bridges: List[List[Bridge]] = [[] for _ in range(h + 1)]
    bid = 0
    for k in range(1, h + 1):
        prev = comp[k - 1]
        on = layer == k
        ca, cb = prev[a[on]], prev[b[on]]
        labels = _label_components(int(prev.max()) + 1, ca, cb)
        comp[k] = labels[prev]
        for c in np.unique(labels).tolist():
            if not (labels[ca] == c).any():
                continue  # no edge of this layer: a component passed through
            bridges[k].append(Bridge(bid=bid, layer=k, comp=c,
                                     children=np.where(labels == c)[0].tolist(),
                                     dcs=np.where(comp[k] == c)[0]))
            bid += 1
    return Layers(h=h, thresholds=thresholds, comp=comp, bridges=bridges)


# --------------------------------------------------------------- diffusion
def diffuse(n: int, src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
            seeds: np.ndarray, base: Optional[np.ndarray], p: PlacementParams,
            n_steps: int) -> np.ndarray:
    """``[B, n]`` heat after ``n_steps`` steps from ``seeds`` (+ ``base``),
    with ``seeds`` as decaying sources; ``weight`` is ``[m]`` or ``[B, m]``
    (a zero weight: no edge for that field).  At the store's constants a
    heavy region graph breaks Theorem 1's bound, and the heat overflows
    float32 to inf and NaN as the store's does; the competition then falls
    back to frequencies."""
    f32 = np.float32
    seeds = np.atleast_2d(np.asarray(seeds, f32))
    B = seeds.shape[0]
    heat = seeds.copy() if base is None else seeds + np.asarray(base, f32)
    if len(src) == 0:
        return seeds.copy()
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.broadcast_to(np.asarray(weight, f32), (B, len(src)))
    rows = (np.arange(B, dtype=np.int64) * n)[:, None]
    half_life = max(n_steps / 4.0, 1.0)
    for k in range(n_steps):
        heat = _step(heat, src, dst, w, seeds, rows, B, n, p, half_life, k)
        if p.round_step is not None:
            heat = p.round_step(heat)
    return heat


@np.errstate(over="ignore", invalid="ignore")
def _step(heat, src, dst, w, seeds, rows, B: int, n: int, p: PlacementParams,
          half_life: float, k: int) -> np.ndarray:
    """One step (Eqs. 7-10) of ``B`` fields over the edge list."""
    f32 = np.float32
    hs, hd = heat[:, src], heat[:, dst]
    on = (hs != hd) & (w > 0)
    src_hot = hs > hd
    hot = (np.where(src_hot, src, dst) + rows)[on]
    cold = (np.where(src_hot, dst, src) + rows)[on]
    n_out = np.maximum(np.bincount(hot, minlength=B * n).astype(f32), f32(1.0))
    flat = heat.reshape(-1)
    dh = f32(p.alpha) * w[on] / n_out[hot] * (flat[hot] - flat[cold])
    delta = (np.bincount(cold, weights=dh, minlength=B * n)
             - np.bincount(hot, weights=dh, minlength=B * n)).astype(f32)
    decay = f32(np.exp(-np.log(2.0) / half_life * k))
    return f32(1.0 - p.gamma) * (heat + delta.reshape(B, n)) + f32(p.beta) * (seeds * decay)


# -------------------------------------------------------- overlap regions
@dataclasses.dataclass
class Region:
    rid: int
    key: Tuple[int, ...]  # the units whose items these are, and no others
    items: np.ndarray


def overlap_regions(units: List["Unit"]) -> List[Region]:
    """Fig. 4a: the items of ``units`` grouped by the set of units holding
    them; regions ordered by that set, items ascending."""
    member: Dict[int, List[int]] = {}
    for i, u in enumerate(units):
        for it in u.items.tolist():
            member.setdefault(it, []).append(i)
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for it in sorted(member):
        groups.setdefault(tuple(member[it]), []).append(it)
    return [Region(rid=r, key=key, items=np.asarray(groups[key], np.int64))
            for r, key in enumerate(sorted(groups))]


def region_edges(regions: List[Region], g) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fig. 4b: regions are adjacent where a graph edge joins items of two
    of them (its two persons, or a person and the edge's own record),
    weighted by the number of such joins."""
    n_r = len(regions)
    of = np.full(g.n_items, -1, np.int64)
    for r in regions:
        of[r.items] = r.rid
    er = of[g.n_nodes + np.arange(g.n_edges)]
    sr, dr = of[g.src], of[g.dst]
    count: Dict[int, int] = {}
    for x, y in ((sr, dr), (sr, er), (er, dr)):
        ok = (x >= 0) & (y >= 0) & (x != y)
        keys = np.minimum(x[ok], y[ok]) * n_r + np.maximum(x[ok], y[ok])
        for key, c in zip(*np.unique(keys, return_counts=True)):
            count[int(key)] = count.get(int(key), 0) + int(c)
    keys = np.array(sorted(count), np.int64)
    return keys // n_r, keys % n_r, np.array([count[k] for k in keys.tolist()], np.float32)


# --------------------------------------------------------------- Eq. (13)
@dataclasses.dataclass
class Unit:
    """A pattern or an overlap region on its way down the layers."""

    items: np.ndarray
    r: np.ndarray  # [D] reads from each DC
    w: np.ndarray  # [D] writes from each DC


def replication_gain(unit: Unit, holder: np.ndarray, children: List[np.ndarray],
                     sizes: np.ndarray, env, lambda1: float, primary: np.ndarray) -> float:
    """Eq. 13's surrogate gain of replicating ``unit`` into each requesting
    child: reads of remote bytes made local (at the mean transfer price from
    the holder's DCs outside the child, or all of them) plus ``lambda1``
    per saved association lookup, less the child's storage and the writes
    it has to take."""
    item_sizes = sizes[unit.items]
    size_sum = float(item_sizes.sum())
    holder = np.unique(np.asarray(holder, np.int64))
    w_total = float(unit.w.sum())
    prim = primary[unit.items]
    gain = 0.0
    for child in children:
        child = np.asarray(child, np.int64)
        r_c = float(unit.r[child].sum())
        if r_c <= 0:
            continue
        size_remote = float(item_sizes[~np.isin(prim, child)].sum())
        outside = holder[~np.isin(holder, child)]
        if len(outside) == 0:
            outside = holder
        net = float(env.c_net[np.ix_(outside, child)].mean())
        store = float(env.c_store[child].mean())
        put = float(env.c_write[child].mean())
        gain += (r_c * size_remote * net + lambda1 * r_c * len(unit.items) * 1e-6
                 - size_sum * store - w_total * (put * len(unit.items) + size_remote * net))
    return gain


# -------------------------------------------------------------- placement
def _competition(regions: List[Region], g, cand: list, p: PlacementParams):
    """Each candidate's heat at every region when the candidate's holdings,
    one super-node joined to each region by its count of graph edges
    between held persons and the region's items, radiate over the region
    graph: ``(heat [C, R + 1] or None, valid [C])``."""
    n_r = len(regions)
    valid = np.zeros(len(cand), bool)
    rs, rd, rw = region_edges(regions, g)
    if len(rs) == 0:
        return None, valid
    of = np.full(g.n_items, -1, np.int64)
    for r in regions:
        of[r.items] = r.rid
    src_r, dst_r = of[g.src], of[g.dst]
    cnt = np.zeros((len(cand), n_r), np.float32)
    for ci, (_, _, held) in enumerate(cand):
        if not held or not sum(len(x) for x in held):
            continue
        mask = np.zeros(g.n_items, bool)
        mask[np.concatenate(held)] = True
        cnt[ci] += np.bincount(dst_r[mask[g.src] & (dst_r >= 0)], minlength=n_r)
        cnt[ci] += np.bincount(src_r[mask[g.dst] & (src_r >= 0)], minlength=n_r)
        valid[ci] = bool(cnt[ci].any())
    if not valid.any():
        return None, valid
    touched = np.where(cnt.any(axis=0))[0]
    src = np.concatenate([rs, np.full(len(touched), n_r, np.int64)])
    dst = np.concatenate([rd, touched])
    weight = np.concatenate([np.broadcast_to(rw, (len(cand), len(rw))), cnt[:, touched]], 1)
    seeds = np.zeros((len(cand), n_r + 1), np.float32)
    seeds[:, n_r] = 1.0
    return diffuse(n_r + 1, src, dst, weight, seeds, None, p, p.dhd_steps), valid


def _winner(heat, valid, rid: int, req: List[int], cand: list, r: np.ndarray) -> int:
    """The position in ``req`` of the candidate whose heat at the region
    is highest; without heat, of the candidate whose DCs read it most."""
    if heat is not None:
        scores = np.asarray([heat[i, rid] if valid[i] else -1.0 for i in req])
        if scores.max() > 0:
            return int(scores.argmax())
    return int(np.asarray([float(r[cand[i][1]].sum()) for i in req]).argmax())


def precache(g, patterns, delta: np.ndarray, p: PlacementParams) -> None:
    """§V: diffuse the patterns' read heat over the whole graph from its
    hottest vertices (those at or above the heat quantile), then give every
    DC a copy of each vertex whose diffused heat reaches that quantile (the
    hottest ``precache_max_per_dc`` if more)."""
    n = g.n_nodes
    r_xy = np.zeros((g.n_items, delta.shape[1]))  # reads of each item from each DC
    for pat in patterns:
        r_xy[pat.items] += pat.r_py[None, :]
    r_v = r_xy[:n].sum(axis=1).astype(np.float32)
    w_raw = r_xy[n:].sum(axis=1).astype(np.float32)
    if r_v.max() <= 0:
        return
    heat0 = r_v / r_v.max()
    theta = float(np.quantile(heat0[heat0 > 0], p.theta_quantile))
    sources = heat0 >= theta
    q0 = np.where(sources, 1.0 / max(int(sources.sum()), 1), 0.0).astype(np.float32)
    w_e = w_raw / max(float(w_raw.max()), 1.0) + np.float32(1e-3)
    heat = diffuse(n, g.src, g.dst, w_e, q0[None], heat0, p, p.precache_steps)[0]
    hot = np.where(heat >= float(np.quantile(heat, p.theta_quantile)))[0]
    if len(hot) > p.precache_max_per_dc:
        hot = hot[np.argsort(-heat[hot])[: p.precache_max_per_dc]]
    for d in range(delta.shape[1]):
        delta[hot[g.partition[hot] != d], d] = True


def place(g, env, patterns, p: Optional[PlacementParams] = None) -> np.ndarray:
    """The replica sets the store's build derives (Algs. 1-2, then the
    pre-cache): every item's own copy at its owner's DC (an edge's at its
    source person's), and the copies the layers deposit."""
    p = p or PlacementParams()
    n, D = g.n_nodes, env.n_dcs
    sizes = g.item_size().astype(np.float32)
    delta = np.zeros((g.n_items, D), bool)
    primary = np.concatenate([g.partition, g.partition[g.src]]).astype(np.int64)
    delta[np.arange(g.n_items), primary] = True
    L = layered_graph(g, env, p.interval_s)
    h = L.h
    held: List[Dict[int, List[Unit]]] = [{} for _ in range(h + 1)]

    # Alg. 1: each read-mostly pattern sinks to the layer of its bound
    for pat in patterns:
        if pat.r_py.sum() <= pat.w_py.sum():
            continue
        unit = Unit(items=pat.items, r=pat.r_py, w=pat.w_py)
        k = L.layer_for(pat.eta * p.gamma_max_s)
        at = [b for b in L.bridges[k] if (unit.r[b.dcs] > 0).any()]
        for b in at:
            held[k].setdefault(b.bid, []).append(unit)
        if not at:
            for d in np.where(pat.r_py > 0)[0].tolist():
                held[0].setdefault(d, []).append(unit)

    bridge = {b.bid: b for layer in L.bridges for b in layer}
    # Alg. 2: from the top layer down
    for k in range(h, 0, -1):
        pools: Dict[int, List[Unit]] = {}
        for bid, units in held[k].items():
            b = bridge[bid]
            kids = L.children(b)
            for unit in units:
                if k == 1 or not kids:
                    targets = [d for d in b.dcs.tolist() if unit.r[d] > 0]
                    target_dcs = [np.asarray([d]) for d in targets]
                    down = 0
                else:
                    chosen = [c for c in kids if (unit.r[c.dcs] > 0).any()]
                    targets = [c.bid for c in chosen]
                    target_dcs = [c.dcs for c in chosen]
                    down = k - 1
                if not targets:
                    continue
                if replication_gain(unit, b.dcs, target_dcs, sizes, env, p.lambda1,
                                    primary) >= 0:
                    for t in targets:
                        held[down].setdefault(t, []).append(unit)
                else:
                    pools.setdefault(b.comp, []).append(unit)
        held[k] = {}
        for comp, units in pools.items():
            regions = overlap_regions(units)
            holder = next(b for b in L.bridges[k] if b.comp == comp)
            kids = L.children(holder)
            if k == 1 or not kids:
                cand = [(d, np.asarray([d]), [u.items for u in held[0].get(d, [])])
                        for d in holder.dcs.tolist()]
                down = 0
            else:
                cand = [(c.bid, c.dcs, [u.items for u in held[k - 1].get(c.bid, [])])
                        for c in kids]
                down = k - 1
            arena = None
            for region in regions:
                r = np.sum([units[i].r for i in region.key], axis=0)
                w = np.sum([units[i].w for i in region.key], axis=0)
                runit = Unit(items=region.items, r=r, w=w)
                req = [i for i, c in enumerate(cand) if r[c[1]].sum() > 0]
                if not req:
                    continue
                if replication_gain(runit, holder.dcs, [cand[i][1] for i in req], sizes,
                                    env, p.lambda1, primary) > 0:
                    targets = [cand[i][0] for i in req]
                else:
                    if arena is None:
                        arena = _competition(regions, g, cand, p)
                    win = _winner(arena[0], arena[1], region.rid, req, cand, r)
                    targets = [cand[req[win]][0]]
                for t in targets:
                    held[down].setdefault(t, []).append(runit)

    for d, units in held[0].items():
        for u in units:
            delta[u.items, d] = True
    precache(g, patterns, delta, p)
    return delta
