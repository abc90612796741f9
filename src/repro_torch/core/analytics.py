"""Offline graph analytics engines (paper §VII workloads) + geo cost simulator.

PageRank / SSSP / HITS / LPA are iterative segment reductions — the same
dataflow a Pregel-style geo engine (RAGraph) executes, so per-iteration
message counts map 1:1 to WAN traffic.  Each runs on ``device`` (``None`` =
the card) as a host loop of tensor ops: a segment sum is ``index_add_``, a
segment min is ``scatter_reduce_(..., "amin")`` into a tensor pre-filled
with the reduction's identity, which is what an empty segment keeps.  On
the card ``index_add_`` sums in no fixed order, so PageRank and HITS agree
with a host run to float rounding; SSSP and LPA (minima) agree exactly.
K-core uses Batagelj-Zaversnik peeling (control-plane NumPy, like the
paper's setup where core iterations = max core number).

``simulate_execution`` prices a layout (vertex -> execution site) under the
paper's BSP model: per iteration, cut edges exchange ``msg_bytes`` messages;
iteration time = straggler compute + straggler link (Eq. 1); WAN volume
accumulates cut bytes — the quantities of Figs. 13-14.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .graph import Graph
from .latency import GeoEnvironment

__all__ = [
    "pagerank",
    "sssp",
    "hits",
    "label_propagation",
    "core_decomposition",
    "ExecStats",
    "simulate_execution",
]

_I32_MAX = torch.iinfo(torch.int32).max


def _edges(src, dst, device: DeviceLike) -> Tuple[torch.Tensor, torch.Tensor]:
    """``src``, ``dst`` (numpy arrays or tensors) as int64 tensors on the
    resolved device: ``scatter_reduce_`` takes int64 indices only, so the
    cast is made once, outside the iteration."""
    dev = resolve_device(device)
    return (torch.as_tensor(src).to(dev, torch.int64),
            torch.as_tensor(dst).to(dev, torch.int64))


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(0, seg, vals)


def _segment_min(vals: torch.Tensor, seg: torch.Tensor, n: int, identity) -> torch.Tensor:
    out = torch.full((n,), identity, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amin", include_self=True)


def pagerank(
    src, dst, n_nodes: int, n_iters: int = 15, damp: float = 0.85,
    device: DeviceLike = None,
) -> torch.Tensor:
    src, dst = _edges(src, dst, device)
    deg = _segment_sum(torch.ones(src.shape, dtype=torch.float32, device=src.device),
                       src, n_nodes)
    deg_src = torch.clamp_min(deg, 1.0)[src]
    r = torch.full((n_nodes,), 1.0 / n_nodes, dtype=torch.float32, device=src.device)
    for _ in range(n_iters):
        agg = _segment_sum(r[src] / deg_src, dst, n_nodes)
        r = (1.0 - damp) / n_nodes + damp * agg
    return r


def sssp(
    src, dst, weight, source: int, n_nodes: int, n_iters: int = 10,
    device: DeviceLike = None,
) -> torch.Tensor:
    src, dst = _edges(src, dst, device)
    weight = torch.as_tensor(weight).to(src.device, torch.float32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=src.device)
    dist = torch.full((n_nodes,), float("inf"), dtype=torch.float32, device=src.device)
    dist[source] = 0.0
    for _ in range(n_iters):
        relax = _segment_min(dist[src] + weight, dst, n_nodes, float("inf"))
        dist = torch.minimum(dist, torch.where(torch.isfinite(relax), relax, inf))
    return dist


def hits(
    src, dst, n_nodes: int, n_iters: int = 20, device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    src, dst = _edges(src, dst, device)
    h = torch.ones(n_nodes, dtype=torch.float32, device=src.device)
    a = torch.ones(n_nodes, dtype=torch.float32, device=src.device)
    for _ in range(n_iters):
        a = _segment_sum(h[src], dst, n_nodes)
        a = a / torch.clamp_min(_norm(a), 1e-12)
        h = _segment_sum(a[dst], src, n_nodes)
        h = h / torch.clamp_min(_norm(h), 1e-12)
    return h, a


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The 2-norm of an f32 vector, accumulated in f64 and rounded once: the
    host's f32 reduction drifts by about 1e-4 relative over a million
    entries, and the last normalisation carries that error into every
    output."""
    return torch.linalg.vector_norm(x, dtype=torch.float64).to(x.dtype)


def label_propagation(
    src, dst, n_nodes: int, n_iters: int = 10, device: DeviceLike = None,
) -> torch.Tensor:
    """Min-label propagation (monotone LPA variant used by delta-accumulative
    engines like Maiter/RAGraph; identical message pattern to classic LPA)."""
    src, dst = _edges(src, dst, device)
    lab = torch.arange(n_nodes, dtype=torch.int32, device=src.device)
    for _ in range(n_iters):
        m1 = _segment_min(lab[src], dst, n_nodes, _I32_MAX)
        m2 = _segment_min(lab[dst], src, n_nodes, _I32_MAX)
        lab = torch.minimum(lab, torch.minimum(m1, m2))
    return lab


def core_decomposition(n_nodes: int, src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, int]:
    """Batagelj-Zaversnik peeling on the *simple* graph (parallel edges and
    self-loops dropped — the standard k-core definition).
    Returns (core numbers, peel rounds)."""
    a, b = np.minimum(src, dst), np.maximum(src, dst)
    keep = a != b
    key = a[keep].astype(np.int64) * n_nodes + b[keep]
    _, idx = np.unique(key, return_index=True)
    src = a[keep][idx]
    dst = b[keep][idx]
    deg = np.bincount(src, minlength=n_nodes) + np.bincount(dst, minlength=n_nodes)
    core = np.zeros(n_nodes, dtype=np.int32)
    alive = np.ones(n_nodes, dtype=bool)
    cur = deg.astype(np.int64).copy()
    k = 0
    rounds = 0
    while alive.any():
        k_candidates = cur[alive]
        k = max(k, int(k_candidates.min()))
        while True:
            peel = alive & (cur <= k)
            if not peel.any():
                break
            rounds += 1
            core[peel] = k
            alive[peel] = False
            # decrement neighbor degrees
            m = peel[src] & alive[dst]
            np.subtract.at(cur, dst[m], 1)
            m = peel[dst] & alive[src]
            np.subtract.at(cur, src[m], 1)
    return core, rounds


# ------------------------------------------------------------ cost simulator
@dataclasses.dataclass
class ExecStats:
    time_s: float
    wan_bytes: float
    cut_edges: int
    n_sites: int
    per_iter_time_s: float


def simulate_execution(
    env: GeoEnvironment,
    g: Graph,
    vertex_site: np.ndarray,  # [n] execution DC per vertex
    n_iters: int,
    msg_bytes: float = 16.0,
    edge_rate: float = 5e7,  # edges/sec processed per DC (compute model)
    assembly_bytes: float = 0.0,
) -> ExecStats:
    """BSP execution model over a geo layout (used for Figs. 13-15).

    Per superstep: every cut edge ships one ``msg_bytes`` message; link time
    follows Eq. 1 aggregated per DC pair; iteration time = straggler
    (max compute + max link) — the paper's bottleneck model (§III-A).
    """
    site_s = vertex_site[g.src]
    site_d = vertex_site[g.dst]
    cut = site_s != site_d
    cut_edges = int(cut.sum())
    sites = np.unique(vertex_site[vertex_site >= 0])
    # per-pair message volume
    pair_bytes: Dict[Tuple[int, int], float] = {}
    if cut_edges:
        pairs, counts = np.unique(
            np.stack([site_s[cut], site_d[cut]], axis=1), axis=0, return_counts=True
        )
        for (a, b), c in zip(pairs, counts):
            pair_bytes[(int(a), int(b))] = float(c) * msg_bytes
    link_t = 0.0
    for (a, b), v in pair_bytes.items():
        link_t = max(link_t, env.rtt_s[a, b] / 2.0 + v / env.bw_Bps[a, b])
    # straggler compute: max local edges per site
    comp_t = 0.0
    for s in sites:
        local_edges = int(((site_s == s) & (site_d == s)).sum()) + int(
            ((site_s == s) ^ (site_d == s)).sum()
        )
        comp_t = max(comp_t, local_edges / edge_rate)
    per_iter = comp_t + link_t
    wan = n_iters * sum(pair_bytes.values()) + assembly_bytes
    return ExecStats(
        time_s=n_iters * per_iter + assembly_bytes / _min_bw(env, sites),
        wan_bytes=wan,
        cut_edges=cut_edges,
        n_sites=len(sites),
        per_iter_time_s=per_iter,
    )


def _min_bw(env: GeoEnvironment, sites: np.ndarray) -> float:
    if len(sites) < 2:
        return float("inf")
    vals = [
        env.bw_Bps[a, b]
        for a in sites
        for b in sites
        if a != b and np.isfinite(env.bw_Bps[a, b])
    ]
    return float(min(vals)) if vals else float("inf")
