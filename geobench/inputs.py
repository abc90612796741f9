"""The benchmark's inputs: graph, environment and k-hop workload from a seed.

A configuration file names its graph's generator (``graph.generator``):
``"knows_graph"``, a Person-knows-Person graph with a heavy-tailed degree
distribution and planted communities (the stand-in for LDBC Datagen's knows
graph), or ``"kronecker"``, Graph500's Kronecker graph (the stand-in for a
follower graph such as the paper's Twitter-2010).  Beside it come Table
I's five data centres and a workload of k-hop patterns shaped like SNB's
interactive reads (1 to 3 hops).  The graph and
the patterns are drawn once from the configuration's own ``base_seed``;
``--seed`` then relabels every vertex and edge by a random permutation.  So
each seed hands the store a different input with exactly the same sizes,
degrees and pattern shapes, and the work of a run does not depend on the
seed.

The arrays made here belong to the benchmark.  :func:`to_port` hands the
program copies of them, and the reference builds from the originals.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["Graph", "Env", "Pattern", "Wiring", "Inputs", "knows_graph", "kronecker_graph",
           "khop_patterns", "make_env", "make_inputs", "to_port", "to_port_batch"]

# Table I of the paper: five Alibaba Cloud DCs, RTT in ms and available
# bandwidth in Mbps between each pair; Table II's Alibaba prices (storage
# $/GB, GET and PUT $/M, transfer $/GB)
DC_NAMES = ["us_east", "us_west", "london", "singapore", "beijing"]
RTT_MS = np.array([
    [0.0, 69.0, 80.0, 225.0, 226.0],
    [69.0, 0.0, 136.0, 178.0, 145.0],
    [80.0, 136.0, 0.0, 213.0, 256.0],
    [225.0, 178.0, 213.0, 0.0, 75.0],
    [226.0, 145.0, 256.0, 75.0, 0.0],
])
BW_MBPS = np.array([
    [0.0, 96.0, 92.0, 66.0, 68.0],
    [96.0, 0.0, 93.0, 80.0, 77.0],
    [92.0, 93.0, 0.0, 74.0, 42.0],
    [66.0, 80.0, 74.0, 0.0, 96.0],
    [68.0, 77.0, 42.0, 96.0, 0.0],
])
PRICES = dict(store=0.016, get=0.10, put=1.40, net=0.043)


@dataclasses.dataclass
class Graph:
    n_nodes: int
    src: np.ndarray  # [m] int32
    dst: np.ndarray  # [m] int32
    node_size: np.ndarray  # [n] float32 bytes
    edge_size: np.ndarray  # [m] float32 bytes
    partition: np.ndarray  # [n] int32 owning DC

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_items(self) -> int:
        return self.n_nodes + self.n_edges

    def item_size(self) -> np.ndarray:
        return np.concatenate([self.node_size, self.edge_size])


@dataclasses.dataclass
class Env:
    names: List[str]
    rtt_s: np.ndarray  # [D, D]
    bw_Bps: np.ndarray  # [D, D], inf on the diagonal
    c_store: np.ndarray  # [D] $/byte
    c_read: np.ndarray  # [D] $/GET
    c_write: np.ndarray  # [D] $/PUT
    c_net: np.ndarray  # [D, D] $/byte

    @property
    def n_dcs(self) -> int:
        return len(self.names)


@dataclasses.dataclass
class Pattern:
    pid: int
    items: np.ndarray  # sorted item ids (vertex v -> v, edge e -> n_nodes + e)
    r_py: np.ndarray  # [D] reads from each origin DC
    w_py: np.ndarray  # [D] writes from each origin DC
    eta: float  # latency requirement coefficient
    start: int = -1  # the start person
    hops: int = 0  # knows hops walked from it


@dataclasses.dataclass
class Wiring:
    """What the knows generator drew each person from, for inserts drawn
    like it: the person's community, each community's home DC, the
    person's Chung-Lu weight (target degree, capped) and the scale that
    took the raw lognormal draws to the configured mean degree."""

    community: np.ndarray  # [n] int64
    home_dc: np.ndarray  # [k] int64
    weight: np.ndarray  # [n] float64
    weight_scale: float


@dataclasses.dataclass
class Inputs:
    g: Graph
    env: Env
    patterns: List[Pattern]
    wiring: Optional[Wiring] = None


def make_env() -> Env:
    d = len(DC_NAMES)
    bw = BW_MBPS * 1e6 / 8.0
    bw[bw == 0] = np.inf
    gb = 1 << 30
    return Env(
        names=list(DC_NAMES), rtt_s=RTT_MS / 1e3, bw_Bps=bw,
        c_store=np.full(d, PRICES["store"] / gb), c_read=np.full(d, PRICES["get"] / 1e6),
        c_write=np.full(d, PRICES["put"] / 1e6), c_net=np.full((d, d), PRICES["net"] / gb),
    )


def knows_graph(gc: dict, n_dcs: int):
    """``(Graph, Wiring)``: an undirected Person-knows-Person graph with heavy-tailed degrees.

    Each person gets a target degree from a lognormal (``degree_sigma``)
    scaled to ``mean_degree`` and capped at ``max_degree``; edges join
    endpoints drawn in proportion to their targets (Chung-Lu), a share
    ``intra_share`` of them inside the person's community.  Each community
    has a home DC, which holds a person with probability ``geo_affinity``
    (otherwise a uniform DC).  Self loops and repeated pairs are dropped;
    each pair is stored once, oriented at random.  Person records are
    lognormal about ``person_bytes``, knows records about ``knows_bytes``."""
    rng = np.random.default_rng(gc["base_seed"])
    n, k = int(gc["n_nodes"]), int(gc["n_communities"])
    comm = np.sort(rng.integers(0, k, size=n))
    w = rng.lognormal(0.0, float(gc["degree_sigma"]), size=n)
    scale = gc["mean_degree"] / w.mean()
    w = np.minimum(w * scale, float(gc["max_degree"]))
    half = 0.5 * float(w.sum())
    m_in = rng.poisson(gc["intra_share"] * half)
    m_out = rng.poisson((1.0 - gc["intra_share"]) * half)
    # intra-community endpoints: a community by its weight, then a member
    starts = np.searchsorted(comm, np.arange(k + 1))
    cw = np.cumsum(w)
    cw0 = np.concatenate([[0.0], cw])
    c_mass = cw0[starts[1:]] - cw0[starts[:-1]]
    c_of = rng.choice(k, size=m_in, p=c_mass / c_mass.sum())

    def member(c: np.ndarray) -> np.ndarray:
        u = cw0[starts[c]] + rng.random(len(c)) * c_mass[c]
        return np.minimum(np.searchsorted(cw, u, side="right"), starts[c + 1] - 1)

    a = np.concatenate([member(c_of), np.searchsorted(cw, rng.random(m_out) * cw[-1],
                                                      side="right")])
    b = np.concatenate([member(c_of), np.searchsorted(cw, rng.random(m_out) * cw[-1],
                                                      side="right")])
    a, b = np.minimum(a, n - 1), np.minimum(b, n - 1)
    keep = a != b
    lo, hi = np.minimum(a[keep], b[keep]), np.maximum(a[keep], b[keep])
    pairs = np.unique(lo.astype(np.int64) * n + hi)
    lo, hi = pairs // n, pairs % n
    flip = rng.random(len(lo)) < 0.5
    src, dst = np.where(flip, hi, lo), np.where(flip, lo, hi)
    home_dc = rng.integers(0, n_dcs, size=k)
    partition = np.where(rng.random(n) < gc["geo_affinity"], home_dc[comm],
                         rng.integers(0, n_dcs, size=n))
    node_size = rng.lognormal(np.log(gc["person_bytes"]), 0.5, size=n).astype(np.float32)
    edge_size = rng.lognormal(np.log(gc["knows_bytes"]), 0.4, size=len(src)).astype(np.float32)
    g = Graph(n_nodes=n, src=src.astype(np.int32), dst=dst.astype(np.int32),
              node_size=node_size, edge_size=edge_size, partition=partition.astype(np.int32))
    return g, Wiring(community=comm.astype(np.int64), home_dc=home_dc.astype(np.int64),
                     weight=w, weight_scale=float(scale))


def kronecker_graph(gc: dict, n_dcs: int):
    """``(Graph, None)``: Graph500's Kronecker graph, directed, follower -> followee.

    The Graph500 specification's generator (its reference code,
    ``kronecker_generator``): ``2**scale`` vertices and
    ``edge_factor * 2**scale`` edges, each edge placing one bit of its
    endpoints a level, the row bit 1 with probability ``1 - (a + b)``, then
    the column bit 1 with probability ``1 - c / (1 - a - b)`` under a row
    bit of 1 and ``1 - a / (a + b)`` under 0; then a random permutation of
    the vertex labels.  The paper's Table III runs Twitter-2010 (Kwak et
    al., WWW 2010), whose stand-in here is this graph at Graph500's
    initiator (0.57, 0.19, 0.19).  Self loops and repeated directed pairs
    are dropped; an edge ``u -> v`` is kept as drawn, with no reverse added,
    and edges are sorted by (source, destination).  Each vertex's home DC is
    drawn uniformly; vertex records are lognormal about ``node_bytes``, edge
    records about ``edge_bytes``.  The generator draws no communities or
    weights, so it hands out no ``Wiring`` and a mix with inserts cannot run
    on it."""
    rng = np.random.default_rng(gc["base_seed"])
    scale = int(gc["scale"])
    n = 1 << scale
    m = int(gc["edge_factor"]) * n
    a, b, c = float(gc["a"]), float(gc["b"]), float(gc["c"])
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        row = rng.random(m) > ab
        col = rng.random(m) > np.where(row, c_norm, a_norm)
        src |= row.astype(np.int64) << bit
        dst |= col.astype(np.int64) << bit
    label = rng.permutation(n)
    src, dst = label[src], label[dst]
    keep = src != dst
    pairs = np.unique(src[keep] * n + dst[keep])
    src, dst = pairs // n, pairs % n
    partition = rng.choice(n_dcs, size=n, p=np.full(n_dcs, 1.0 / n_dcs))
    node_size = rng.lognormal(np.log(gc["node_bytes"]), 0.5, size=n).astype(np.float32)
    edge_size = rng.lognormal(np.log(gc["edge_bytes"]), 0.4, size=len(src)).astype(np.float32)
    g = Graph(n_nodes=n, src=src.astype(np.int32), dst=dst.astype(np.int32),
              node_size=node_size, edge_size=edge_size, partition=partition.astype(np.int32))
    return g, None


GENERATORS = {"knows_graph": knows_graph, "kronecker": kronecker_graph}


def _walk_lists(g: Graph, direction: str):
    """``(indptr, neighbour, edge id)`` of the edges a walk may take from
    each vertex: ``"both"`` ways or ``"out"`` (source to destination)."""
    s, d = g.src.astype(np.int64), g.dst.astype(np.int64)
    eid = np.arange(g.n_edges)
    if direction == "both":
        s, d, eid = np.concatenate([s, d]), np.concatenate([d, s]), np.concatenate([eid] * 2)
    elif direction != "out":
        raise ValueError(f"unknown walk direction {direction!r}")
    order = np.argsort(s, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(s, minlength=g.n_nodes))])
    return indptr, d[order], eid[order]


def khop_patterns(g: Graph, pc: dict, n_dcs: int) -> List[Pattern]:
    """Patterns shaped like SNB's interactive reads: a start person and the
    persons and knows edges met walking ``hops`` steps out from it (1 to 3,
    drawn with ``hop_weights``), taking ``branch`` random friends of each
    person reached, along the edges ``direction`` names (``"both"``, the
    default, or ``"out"``: a follow list is directed).  Start
    persons are Zipf-popular over a hot core of ``n_hot_sources``, taken
    among the vertices with at least ``start_min_degree`` edges in that
    direction (default 0: every vertex).  A pattern is read from its start
    person's DC, from a second DC with probability 0.35, written with
    probability 0.3, and gets a latency coefficient from (0.25, 0.5, 0.75,
    1.0)."""
    rng = np.random.default_rng(pc["base_seed"])
    n = g.n_nodes
    indptr, nbr, nbr_e = _walk_lists(g, pc.get("direction", "both"))
    ranks = rng.permutation(n) + 1
    # the Zipf rank of each vertex among those of the least degree
    by_rank = np.argsort(ranks)
    ok = np.diff(indptr)[by_rank] >= int(pc.get("start_min_degree", 0))
    ranks[by_rank] = np.where(ok, np.cumsum(ok), n + 1)
    popularity = 1.0 / ranks.astype(np.float64) ** 1.4
    mask = np.zeros(n)
    mask[by_rank[ok][: pc["n_hot_sources"]]] = 1.0
    popularity *= mask
    popularity /= popularity.sum()
    hop_choices = np.arange(1, len(pc["hop_weights"]) + 1)
    hop_p = np.asarray(pc["hop_weights"], np.float64) / np.sum(pc["hop_weights"])
    out: List[Pattern] = []
    for pid in range(pc["n_patterns"]):
        v0 = int(rng.choice(n, p=popularity))
        hops = int(rng.choice(hop_choices, p=hop_p))
        verts, edges, frontier = {v0}, set(), [v0]
        for _ in range(hops):
            nxt = []
            for u in frontier:
                lo, hi = int(indptr[u]), int(indptr[u + 1])
                if hi == lo:
                    continue
                for s in rng.choice(hi - lo, size=min(pc["branch"], hi - lo), replace=False):
                    v = int(nbr[lo + s])
                    edges.add(int(nbr_e[lo + s]))
                    if v not in verts:
                        verts.add(v)
                        nxt.append(v)
            frontier = nxt
        items = np.unique(np.concatenate([
            np.fromiter(verts, np.int64, len(verts)),
            n + np.fromiter(edges, np.int64, len(edges)),
        ]))
        origin = int(g.partition[v0])
        r_py = np.zeros(n_dcs)
        base = float(1 + rng.poisson(4) + 40 * popularity[v0] * n / 10)
        r_py[origin] = base
        if rng.random() < 0.35:
            other = int(rng.choice([d for d in range(n_dcs) if d != origin]))
            r_py[other] = max(1.0, base * rng.uniform(0.2, 0.8))
        w_py = np.zeros(n_dcs)
        if rng.random() < 0.3:
            w_py[origin] = base * rng.uniform(0.05, 0.3)
        eta = float(rng.choice([0.25, 0.5, 0.75, 1.0]))
        out.append(Pattern(pid=pid, items=items, r_py=r_py, w_py=w_py, eta=eta,
                           start=v0, hops=hops))
    return out


def _relabel(g: Graph, patterns: List[Pattern], seed: int, wiring: Optional[Wiring]):
    """The same graph, patterns and wiring (if any) under a seeded
    permutation of the vertex ids; edges are re-sorted by (src, dst)."""
    rng = np.random.default_rng(seed)
    n = g.n_nodes
    pv = rng.permutation(n)  # old vertex -> new vertex
    src = pv[g.src].astype(np.int64)
    dst = pv[g.dst].astype(np.int64)
    order = np.argsort(src * n + dst, kind="stable")  # new edge k = old edge order[k]
    pe = np.empty(len(order), np.int64)
    pe[order] = np.arange(len(order))  # old edge -> new edge
    node_size = np.empty_like(g.node_size)
    node_size[pv] = g.node_size
    partition = np.empty_like(g.partition)
    partition[pv] = g.partition
    g2 = Graph(n_nodes=n, src=src[order].astype(np.int32), dst=dst[order].astype(np.int32),
               node_size=node_size, edge_size=g.edge_size[order].copy(), partition=partition)
    imap = np.concatenate([pv, n + pe])
    pats = [Pattern(pid=p.pid, items=np.sort(imap[p.items]), r_py=p.r_py.copy(),
                    w_py=p.w_py.copy(), eta=p.eta, start=int(pv[p.start]), hops=p.hops)
            for p in patterns]
    if wiring is None:
        return g2, pats, None
    community = np.empty_like(wiring.community)
    community[pv] = wiring.community
    weight = np.empty_like(wiring.weight)
    weight[pv] = wiring.weight
    return g2, pats, Wiring(community=community, home_dc=wiring.home_dc.copy(),
                            weight=weight, weight_scale=wiring.weight_scale)


def make_inputs(config: dict, seed: int) -> Inputs:
    """The configuration's graph and workload, relabelled by ``seed``."""
    env = make_env()
    gc = config["graph"]
    if gc["generator"] not in GENERATORS:
        raise ValueError(f"unknown graph generator {gc['generator']!r}")
    g, wiring = GENERATORS[gc["generator"]](gc, env.n_dcs)
    pats = khop_patterns(g, config["patterns"], env.n_dcs)
    g, pats, wiring = _relabel(g, pats, seed, wiring)
    return Inputs(g=g, env=env, patterns=pats, wiring=wiring)


def to_port(inputs: Inputs):
    """``(Graph, GeoEnvironment, Workload)`` of the port, built from copies
    of the benchmark's arrays; the port derives its own item frequencies."""
    from repro_torch.core.graph import Graph as PGraph
    from repro_torch.core.latency import GeoEnvironment as PEnv
    from repro_torch.core.patterns import Pattern as PPattern
    from repro_torch.core.patterns import Workload as PWorkload

    g, env = inputs.g, inputs.env
    pg = PGraph(
        n_nodes=int(g.n_nodes), src=g.src.copy(), dst=g.dst.copy(),
        node_size=g.node_size.copy(), edge_size=g.edge_size.copy(),
        partition=g.partition.copy(),
    )
    penv = PEnv(
        names=list(env.names), rtt_s=env.rtt_s.copy(), bw_Bps=env.bw_Bps.copy(),
        c_store=env.c_store.copy(), c_read=env.c_read.copy(),
        c_write=env.c_write.copy(), c_net=env.c_net.copy(),
    )
    pats = [
        PPattern(pid=p.pid, items=p.items.copy(), r_py=p.r_py.copy(),
                 w_py=p.w_py.copy(), eta=p.eta)
        for p in inputs.patterns
    ]
    return pg, penv, PWorkload.from_patterns(pats, pg.n_items, penv.n_dcs)


def to_port_batch(batch):
    """The port's ``MutationBatch`` of one sealed batch of inserts, built
    from copies of the benchmark's arrays."""
    from repro_torch.streaming.mutation_log import MutationBatch

    none = np.zeros(0, np.int64)
    return MutationBatch(
        add_vertex_size=batch.vertex_size.copy(),
        add_vertex_partition=batch.vertex_partition.copy(),
        del_vertex_ids=none.copy(),
        add_edge_src=batch.edge_src.copy(),
        add_edge_dst=batch.edge_dst.copy(),
        add_edge_size=batch.edge_size.copy(),
        del_edge_ids=none.copy(),
    )
