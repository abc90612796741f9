"""Synthetic graph generators with the structural knobs of the paper's
datasets (LDBC-SNB / UK-2005 / Twitter-2010): power-law degrees, community
structure, geo partitions.  Scaled-down but structure-preserving (DESIGN §9).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import Graph

__all__ = [
    "rmat_graph",
    "community_graph",
    "make_benchmark_graph",
    "diurnal_demand_trace",
]


def _geo_partition(n: int, n_dcs: int, rng: np.random.Generator) -> np.ndarray:
    """Contiguous id-range partition with ragged sizes — mimics regional
    ingest (ids are assigned locally, so ranges are geo-coherent)."""
    cuts = np.sort(rng.choice(np.arange(1, n), size=n_dcs - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    part = np.zeros(n, dtype=np.int32)
    for d in range(n_dcs):
        part[bounds[d] : bounds[d + 1]] = d
    return part


def rmat_graph(
    scale: int,
    edge_factor: int = 8,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    n_dcs: int = 5,
) -> Graph:
    """R-MAT generator (power-law, Twitter/UK-like).  n = 2^scale nodes."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src_bit = (r >= a + b) & (r < a + b + c) | (r >= a + b + c)
        dst_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    mask = src != dst
    src, dst = src[mask], dst[mask]
    # dedupe
    key = src * n + dst
    _, idx = np.unique(key, return_index=True)
    src, dst = src[idx], dst[idx]
    partition = _geo_partition(n, n_dcs, rng)
    sizes = rng.lognormal(mean=np.log(256.0), sigma=0.5, size=n).astype(np.float32)
    esizes = rng.lognormal(mean=np.log(64.0), sigma=0.4, size=len(src)).astype(
        np.float32
    )
    return Graph(
        n_nodes=n,
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        node_size=sizes,
        edge_size=esizes,
        partition=partition,
    )


def community_graph(
    n_nodes: int,
    n_communities: int = 8,
    p_in: float = 0.05,
    p_out: float = 0.002,
    seed: int = 0,
    n_dcs: int = 5,
    geo_affinity: float = 0.8,
) -> Graph:
    """Planted-partition graph (SNB-like community structure).

    ``geo_affinity`` biases each community's vertices toward one home DC —
    the generative assumption behind geo partitioning (regional data)."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_communities, size=n_nodes)
    order = np.argsort(comm)
    comm = comm[order]
    src_l, dst_l = [], []
    for ci in range(n_communities):
        members = np.where(comm == ci)[0]
        k = len(members)
        if k < 2:
            continue
        m_in = rng.binomial(k * (k - 1) // 2, p_in)
        s = members[rng.integers(0, k, size=m_in)]
        d = members[rng.integers(0, k, size=m_in)]
        src_l.append(s)
        dst_l.append(d)
    m_out = rng.binomial(n_nodes * (n_nodes - 1) // 2, p_out)
    src_l.append(rng.integers(0, n_nodes, size=m_out))
    dst_l.append(rng.integers(0, n_nodes, size=m_out))
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    mask = src != dst
    src, dst = src[mask], dst[mask]
    key = src.astype(np.int64) * n_nodes + dst
    _, idx = np.unique(key, return_index=True)
    src, dst = src[idx], dst[idx]
    home_dc = rng.integers(0, n_dcs, size=n_communities)
    partition = np.where(
        rng.random(n_nodes) < geo_affinity,
        home_dc[comm],
        rng.integers(0, n_dcs, size=n_nodes),
    )
    sizes = rng.lognormal(mean=np.log(256.0), sigma=0.5, size=n_nodes).astype(
        np.float32
    )
    esizes = rng.lognormal(mean=np.log(64.0), sigma=0.4, size=len(src)).astype(
        np.float32
    )
    return Graph(
        n_nodes=n_nodes,
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        node_size=sizes,
        edge_size=esizes,
        partition=partition.astype(np.int32),
    )


def diurnal_demand_trace(
    patterns: Sequence,
    n_dcs: int,
    n_requests: int,
    period_s: float,
    n_periods: int = 2,
    kappa: float = 6.0,
    locality: float = 0.9,
    seed: int = 0,
    deadline_s: Optional[float] = None,
    priority: int = 0,
) -> Tuple[List[Tuple[float, np.ndarray, int, int, Optional[float]]], np.ndarray]:
    """Follow-the-sun request trace: the demand peak sweeps across the DCs.

    Per-origin arrival intensity is a von-Mises bump over the diurnal phase,
    centred at phase ``d / n_dcs`` for DC *d* — as simulated time advances
    one ``period_s``, the traffic peak visits every DC once, in order (the
    workload of the paper's geo-distributed setting: each region is busy
    during its local daytime).  Each request draws a pattern *homed* at its
    origin with probability ``locality`` (home = pattern index mod
    ``n_dcs``), so the hot item set rotates with the peak and placement has
    something to chase.

    Returns ``(rows, handoffs)``:

    * ``rows`` — ``(t, items, origin, priority, deadline_s)`` tuples sorted
      by arrival time, feedable straight into ``StoreClient.submit(...,
      at=t)``;
    * ``handoffs`` — the analytic peak-handoff instants ``period_s * (c +
      (d + 0.5) / n_dcs)``, midway between consecutive DC peaks: the moments
      a reactive placement is stalest and a one-window-ahead forecast pays.
    """
    if n_dcs < 1:
        raise ValueError(f"need at least one DC, got {n_dcs}")
    if not patterns:
        raise ValueError("need at least one pattern")
    rng = np.random.default_rng(seed)
    total_s = float(n_periods) * float(period_s)
    t = np.sort(rng.uniform(0.0, total_s, size=int(n_requests)))
    phase = t / float(period_s)
    # von-Mises-shaped origin weights, peak for DC d at phase d/n_dcs
    ang = 2.0 * np.pi * (phase[:, None] - np.arange(n_dcs)[None, :] / n_dcs)
    w = np.exp(kappa * (np.cos(ang) - 1.0))
    w /= w.sum(axis=1, keepdims=True)
    u = rng.random(len(t))
    origins = (w.cumsum(axis=1) < u[:, None]).sum(axis=1)
    home = np.arange(len(patterns)) % n_dcs
    by_home = [np.where(home == d)[0] for d in range(n_dcs)]
    rows: List[Tuple[float, np.ndarray, int, int, Optional[float]]] = []
    for k in range(len(t)):
        d = int(origins[k])
        pool = by_home[d]
        if len(pool) and rng.random() < locality:
            pi = int(pool[rng.integers(0, len(pool))])
        else:
            pi = int(rng.integers(0, len(patterns)))
        rows.append((float(t[k]), patterns[pi].items, d, priority, deadline_s))
    handoffs = np.array(
        [
            period_s * (c + (d + 0.5) / n_dcs)
            for c in range(int(n_periods))
            for d in range(n_dcs)
        ],
        dtype=np.float64,
    )
    return rows, handoffs


def make_benchmark_graph(name: str, seed: int = 0, n_dcs: int = 5) -> Graph:
    """The three benchmark graph families of Table III, scaled to CPU:

    * ``snb`` — community-structured social network (LDBC-SNB analogue)
    * ``uk``  — high-fanout power-law web graph (UK-2005 analogue)
    * ``tw``  — heavy-tailed follower graph (Twitter-2010 analogue)
    * ``wiki`` — small dense vote graph (WIKI-vote analogue, Fig. 9)
    """
    if name == "snb":
        return community_graph(4096, n_communities=12, seed=seed, n_dcs=n_dcs)
    if name == "uk":
        return rmat_graph(12, edge_factor=12, a=0.65, b=0.15, c=0.15, seed=seed, n_dcs=n_dcs)
    if name == "tw":
        return rmat_graph(12, edge_factor=16, a=0.57, b=0.19, c=0.19, seed=seed, n_dcs=n_dcs)
    if name == "wiki":
        return rmat_graph(9, edge_factor=14, seed=seed, n_dcs=min(n_dcs, 4))
    raise ValueError(f"unknown benchmark graph {name!r}")
