"""Geo partitioners: assign vertices to DCs / mesh shards.

A copy of ``repro/data/partition.py`` over the port's own
:func:`repro_torch.core.graph.build_csr`; the same seed gives the same
partition.  ``hash_partition`` is the throughput default;
``balanced_bfs_partition`` produces locality-preserving partitions (fewer
bridge edges), which is what makes the layered graph's Layer_0 meaningful.
"""
from __future__ import annotations


import numpy as np

from ..core.graph import build_csr

__all__ = ["hash_partition", "balanced_bfs_partition", "edge_cut"]


def hash_partition(n_nodes: int, n_parts: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_parts, size=n_nodes).astype(np.int32)


def balanced_bfs_partition(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    n_parts: int,
    seed: int = 0,
) -> np.ndarray:
    """Multi-seed BFS growth with per-part capacity (LDG-flavored).

    Grows ``n_parts`` regions from random seeds simultaneously; each step the
    least-loaded part claims the next frontier vertex.  Produces contiguous,
    balanced regions with low edge cut — a stand-in for METIS."""
    rng = np.random.default_rng(seed)
    csr = build_csr(n_nodes, src, dst, symmetrize=True)
    part = np.full(n_nodes, -1, dtype=np.int32)
    cap = int(np.ceil(n_nodes / n_parts))
    loads = np.zeros(n_parts, dtype=np.int64)
    frontiers = [list() for _ in range(n_parts)]
    seeds = rng.choice(n_nodes, size=n_parts, replace=False)
    for p, s in enumerate(seeds):
        part[s] = p
        loads[p] += 1
        frontiers[p].extend(csr.neighbors(int(s)).tolist())
    active = True
    while active:
        active = False
        for p in np.argsort(loads):
            if loads[p] >= cap:
                continue
            f = frontiers[p]
            while f:
                v = f.pop()
                if part[v] < 0:
                    part[v] = p
                    loads[p] += 1
                    frontiers[p].extend(csr.neighbors(int(v)).tolist())
                    active = True
                    break
    # unreachable leftovers -> least loaded
    for v in np.where(part < 0)[0]:
        p = int(np.argmin(loads))
        part[v] = p
        loads[p] += 1
    return part


def edge_cut(part: np.ndarray, src: np.ndarray, dst: np.ndarray) -> float:
    if len(src) == 0:
        return 0.0
    return float((part[src] != part[dst]).mean())
