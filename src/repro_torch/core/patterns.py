"""Graph patterns and overlap-region decomposition (paper §II, §V Fig. 4).

A *pattern* is the set of data items (vertices + edges) matched by a graph
query — generated here as k-hop random-walk neighborhoods, mirroring the
paper's 3-hop walk workloads on UK/TW.  Patterns carry per-origin read/write
frequencies and a latency-SLO coefficient ``eta`` (constraint (d) of Eq. 6).

*Overlap regions* are the Venn cells of a pattern set: every item is keyed by
the bitmask of patterns containing it, and each distinct bitmask forms one
disjoint region (paper Fig. 4a's {r1..r7}).  Regions are the placement
granularity of Algorithm 2.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import CSR, Graph, build_csr

__all__ = [
    "Pattern",
    "Workload",
    "generate_khop_patterns",
    "aggregate_item_frequencies",
    "OverlapRegion",
    "decompose_overlap_regions",
    "region_adjacency",
]


@dataclasses.dataclass
class Pattern:
    pid: int
    items: np.ndarray  # item ids (vertex v -> v; edge e -> n_nodes + e)
    r_py: np.ndarray  # [D] read frequency per origin DC
    w_py: np.ndarray  # [D] write frequency per origin DC
    eta: float = 1.0  # latency requirement coefficient, (0, 1]

    @property
    def read_rate(self) -> float:
        return float(self.r_py.sum())

    @property
    def write_rate(self) -> float:
        return float(self.w_py.sum())


@dataclasses.dataclass
class Workload:
    patterns: List[Pattern]
    n_items: int
    n_dcs: int
    r_xy: np.ndarray  # [I, D] aggregated per-item read frequencies
    w_xy: np.ndarray  # [I, D]

    @staticmethod
    def from_patterns(patterns: List[Pattern], n_items: int, n_dcs: int) -> "Workload":
        r, w = aggregate_item_frequencies(patterns, n_items, n_dcs)
        return Workload(patterns=patterns, n_items=n_items, n_dcs=n_dcs, r_xy=r, w_xy=w)


def generate_khop_patterns(
    g: Graph,
    csr: CSR,
    n_patterns: int,
    hops: int = 3,
    branch: int = 2,
    seed: int = 0,
    write_fraction: float = 0.3,
    freq_zipf_a: float = 1.4,
    eta_choices: Sequence[float] = (0.25, 0.5, 0.75, 1.0),
    n_dcs: Optional[int] = None,
    n_hot_sources: Optional[int] = None,
) -> List[Pattern]:
    """K-hop random-walk patterns with Zipf-skewed source popularity.

    Each pattern expands ``branch`` random neighbors per frontier vertex for
    ``hops`` steps; visited vertices and traversed edges become the pattern's
    items.  Source vertices are drawn Zipf-skewed so hot regions emerge (the
    precondition for the paper's conduction/superposition observations).
    ``eta`` is drawn uniformly from ``eta_choices`` (paper: random latency
    requirement mapped to one layer's interval).
    """
    rng = np.random.default_rng(seed)
    D = n_dcs if n_dcs is not None else int(g.partition.max()) + 1
    # Zipf-ish popularity over vertices (rank-based to avoid huge tails).
    # ``n_hot_sources`` restricts sources to a fixed hot core — the paper's
    # observed access pattern (celebrity regions attract most queries), and
    # what makes historical placement predictive for test patterns.
    ranks = rng.permutation(g.n_nodes) + 1
    popularity = 1.0 / ranks.astype(np.float64) ** freq_zipf_a
    if n_hot_sources is not None and n_hot_sources < g.n_nodes:
        hot = np.argsort(ranks)[:n_hot_sources]
        mask = np.zeros(g.n_nodes)
        mask[hot] = 1.0
        popularity = popularity * mask
    popularity /= popularity.sum()

    # CSR edge lookup: map (u, slot) -> edge item id needs original edge index;
    # build a parallel CSR of edge ids.
    eid_csr = build_csr(
        g.n_nodes, g.src, g.dst, weights=np.arange(g.n_edges, dtype=np.float32)
    )

    patterns: List[Pattern] = []
    for pid in range(n_patterns):
        v0 = int(rng.choice(g.n_nodes, p=popularity))
        verts = {v0}
        edges: set = set()
        frontier = [v0]
        for _ in range(hops):
            nxt: List[int] = []
            for u in frontier:
                lo, hi = int(eid_csr.indptr[u]), int(eid_csr.indptr[u + 1])
                deg = hi - lo
                if deg == 0:
                    continue
                k = min(branch, deg)
                sel = rng.choice(deg, size=k, replace=False)
                for s in sel:
                    v = int(eid_csr.indices[lo + s])
                    e = int(eid_csr.weights[lo + s])
                    edges.add(e)
                    if v not in verts:
                        verts.add(v)
                        nxt.append(v)
            frontier = nxt
            if not frontier:
                break
        items = np.concatenate(
            [
                np.fromiter(verts, dtype=np.int64, count=len(verts)),
                g.n_nodes + np.fromiter(edges, dtype=np.int64, count=len(edges)),
            ]
        )
        origin = int(g.partition[v0])
        r_py = np.zeros(D)
        base = float(1 + rng.poisson(4) + 40 * popularity[v0] * g.n_nodes / 10)
        r_py[origin] = base
        # some patterns are requested from a second, remote origin
        if rng.random() < 0.35 and D > 1:
            other = int(rng.choice([d for d in range(D) if d != origin]))
            r_py[other] = max(1.0, base * rng.uniform(0.2, 0.8))
        w_py = np.zeros(D)
        if rng.random() < write_fraction:
            w_py[origin] = base * rng.uniform(0.05, 0.3)
        eta = float(rng.choice(np.asarray(eta_choices)))
        patterns.append(Pattern(pid=pid, items=np.unique(items), r_py=r_py, w_py=w_py, eta=eta))
    return patterns


def aggregate_item_frequencies(
    patterns: Sequence[Pattern], n_items: int, n_dcs: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-item R_xy / W_xy from pattern-level frequencies (access logs)."""
    r = np.zeros((n_items, n_dcs), dtype=np.float64)
    w = np.zeros((n_items, n_dcs), dtype=np.float64)
    for p in patterns:
        r[p.items] += p.r_py[None, :]
        w[p.items] += p.w_py[None, :]
    return r, w


# ------------------------------------------------------------ overlap regions
@dataclasses.dataclass
class OverlapRegion:
    rid: int
    key: Tuple[int, ...]  # sorted pids whose intersection cell this is
    items: np.ndarray
    degree: int  # |key| — overlap multiplicity (superposition weight)


def decompose_overlap_regions(
    patterns: Sequence[Pattern], n_items: int, vectorized: bool = True
) -> List[OverlapRegion]:
    """Split a pattern set into disjoint Venn regions (paper Fig. 4a).

    Items sharing the same membership bitmask form one region.  Scales to
    many patterns because only realized bitmasks are materialized.

    The default path stacks every (item, pattern) incidence pair, builds the
    bit-packed membership matrix, and groups identical rows with one
    ``np.unique(axis=0)`` pass — no per-item Python loop.
    ``vectorized=False`` keeps the per-item dict reference it is
    oracle-tested against in ``tests/test_patterns.py``; the two agree
    whenever pattern ids are distinct and each pattern's items are unique —
    invariants every generator in this repo upholds (the reference would
    key duplicate incidences as repeated pids).
    """
    if not vectorized:
        return _decompose_overlap_regions_py(patterns, n_items)
    pats = sorted((p for p in patterns if len(p.items)), key=lambda p: p.pid)
    if not pats:
        return []
    P = len(pats)
    counts = [len(p.items) for p in pats]
    items_all = np.concatenate([np.asarray(p.items, dtype=np.int64) for p in pats])
    col = np.repeat(np.arange(P, dtype=np.int64), counts)
    touched, inv = np.unique(items_all, return_inverse=True)
    member = np.zeros((len(touched), P), dtype=bool)
    member[inv, col] = True
    # columns are in ascending-pid order, so a row's set bits read out as the
    # sorted key tuple; packing keeps np.unique's row compare at P/8 bytes
    packed = np.packbits(member, axis=1)
    rows, region_of = np.unique(packed, axis=0, return_inverse=True)
    order = np.argsort(region_of, kind="stable")  # items ascending per region
    bounds = np.concatenate([[0], np.cumsum(np.bincount(region_of, minlength=len(rows)))])
    pid_arr = np.asarray([p.pid for p in pats], dtype=np.int64)
    keyed: List[Tuple[Tuple[int, ...], np.ndarray]] = []
    for r in range(len(rows)):
        bits = np.unpackbits(rows[r])[:P].astype(bool)
        key = tuple(int(q) for q in pid_arr[bits])
        keyed.append((key, touched[order[bounds[r] : bounds[r + 1]]]))
    keyed.sort(key=lambda kv: kv[0])  # the reference orders cells by key
    return [
        OverlapRegion(rid=rid, key=key, items=items, degree=len(key))
        for rid, (key, items) in enumerate(keyed)
    ]


def _decompose_overlap_regions_py(
    patterns: Sequence[Pattern], n_items: int
) -> List[OverlapRegion]:
    """Per-item membership-dict reference (the pre-vectorization path)."""
    membership: Dict[int, List[int]] = {}
    for p in patterns:
        for x in p.items.tolist():
            membership.setdefault(x, []).append(p.pid)
    cells: Dict[Tuple[int, ...], List[int]] = {}
    for x, pids in membership.items():
        cells.setdefault(tuple(sorted(pids)), []).append(x)
    regions = []
    for rid, (key, items) in enumerate(sorted(cells.items())):
        regions.append(
            OverlapRegion(
                rid=rid,
                key=key,
                items=np.asarray(sorted(items), dtype=np.int64),
                degree=len(key),
            )
        )
    return regions


def region_adjacency(
    regions: Sequence[OverlapRegion], g: Graph
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Region-graph edges for the DHD competition (paper Fig. 4b).

    Two regions are adjacent when the graph has an edge whose endpoint
    vertices (or the edge item itself vs its endpoints) fall in different
    regions; the weight counts such connections.  Returns (src, dst, w).
    """
    n_regions = len(regions)
    item_region = np.full(g.n_items, -1, dtype=np.int64)
    for r in regions:
        item_region[r.items] = r.rid
    er = item_region[g.n_nodes + np.arange(g.n_edges)]
    sr = item_region[g.src]
    dr = item_region[g.dst]
    # canonical (min, max) pair keys over the three incidence kinds, counted
    # with one vectorized np.unique pass (this runs once per decomposition
    # pool — the per-edge Python-dict version was a placement hot spot)
    keys = []
    for a, b in ((sr, dr), (sr, er), (er, dr)):
        valid = (a >= 0) & (b >= 0) & (a != b)
        lo = np.minimum(a[valid], b[valid])
        hi = np.maximum(a[valid], b[valid])
        keys.append(lo * n_regions + hi)
    flat = np.concatenate(keys) if keys else np.zeros(0, dtype=np.int64)
    if len(flat) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0, dtype=np.float32)
    uniq, counts = np.unique(flat, return_counts=True)
    return uniq // n_regions, uniq % n_regions, counts.astype(np.float32)
