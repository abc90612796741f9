"""GeoLayer applied at mesh scale — the paper's technique over device shards.

A device mesh is a geo topology in miniature: device shards are "DCs", the
intra-pod fabric is the intra-region WAN, the cross-pod links the
cross-region WAN.  Integration points:

  * ``mesh_env``        — GeoEnvironment over mesh shards (2-level latency:
                          intra-pod vs cross-pod).
  * ``mesh_devices``    — one ``torch.device`` per store shard.
  * ``plan_gnn_halo``   — Eq. 13 replication gain per (boundary vertex,
                          remote shard): heat (access frequency x degree) vs
                          storage+sync cost decides which remote vertices are
                          replicated into each shard's halo.
  * ``plan_expert_replicas`` / ``plan_row_replicas`` — DHD-style heat over
                          router/row access stats -> replication factors for
                          hot MoE experts / embedding rows.

The layered-graph machinery itself runs unchanged on ``mesh_env`` — a
mesh-level layered graph has exactly 2 bridge layers.  The planners are
numpy, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.graph import Graph
from ..core.latency import GeoEnvironment
from ..device import DeviceLike, resolve_device

__all__ = [
    "mesh_env",
    "mesh_devices",
    "HaloPlan",
    "plan_gnn_halo",
    "plan_expert_replicas",
    "plan_row_replicas",
]

# the JAX package's fabric constants (a TPU pod's ICI and DCN links): the
# relative costs mesh_env prices, kept for parity; nothing here measures them
ICI_RTT_S = 2e-6
ICI_BW_BPS = 5e10  # ~50 GB/s per link
DCN_RTT_S = 1e-4
DCN_BW_BPS = 2.5e9  # ~2.5 GB/s per host pair across pods


def mesh_env(n_shards: int, shards_per_pod: Optional[int] = None) -> GeoEnvironment:
    """Two-level GeoEnvironment over mesh shards (devices or device groups)."""
    spp = shards_per_pod or n_shards
    pod = np.arange(n_shards) // spp
    same = pod[:, None] == pod[None, :]
    rtt = np.where(same, ICI_RTT_S, DCN_RTT_S)
    bw = np.where(same, ICI_BW_BPS, DCN_BW_BPS)
    np.fill_diagonal(rtt, 0.0)
    bw = bw.astype(np.float64)
    np.fill_diagonal(bw, np.inf)
    # cost model: relative units (no $ pricing inside a cluster); transfer
    # "cost" ~ 1/bandwidth so Eq. 13 trades bytes moved for bytes stored.
    return GeoEnvironment(
        names=[f"shard{i}" for i in range(n_shards)],
        rtt_s=rtt,
        bw_Bps=bw,
        c_store=np.full(n_shards, 1e-12),
        c_read=np.full(n_shards, 0.0),
        c_write=np.full(n_shards, 0.0),
        c_net=1.0 / bw,
    )


def mesh_devices(n_shards: int, device: DeviceLike = None) -> List[torch.device]:
    """One ``torch.device`` per store shard.

    On the card (``device`` None or ``"cuda"``) the shards cycle over
    ``torch.cuda.device_count()`` cards: on one card every shard lands on
    ``cuda:0``, the single-process layout (functionally identical, payload
    transfers degenerate to same-device copies).  ``"cpu"`` gives every
    shard the host."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_shards
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(n_shards)]


@dataclasses.dataclass
class HaloPlan:
    """Per-shard halo: remote vertex ids replicated into the shard."""

    halo: List[np.ndarray]  # shard -> remote vertex ids
    replicated_bytes: float
    cut_edges_before: int
    cut_edges_resolved: int  # cross-shard edges whose remote endpoint is now local

    @property
    def resolve_frac(self) -> float:
        return self.cut_edges_resolved / max(self.cut_edges_before, 1)


def plan_gnn_halo(
    g: Graph,
    n_shards: int,
    vertex_heat: Optional[np.ndarray] = None,
    n_layers: int = 4,
    write_rate: float = 1.0,
    budget_frac: float = 0.25,
    bytes_per_vertex: float = 512.0,
) -> HaloPlan:
    """Eq. 13 specialized to mesh halos (uniform intra-cluster latency, so
    the layered decomposition collapses to per-shard, per-vertex gains):

      gain(v, s) = n_layers * reads(v->s) * bytes_v / BW        (saved gathers)
                   - bytes_v * c_store - write_rate * bytes_v / BW (sync)

    reads(v->s) = edges from v into shard s x per-step access (heat).  Every
    positive-gain (v, s) pair is replicated, best-gain first, bounded by
    ``budget_frac`` x local vertices per shard (HBM budget)."""
    part = g.partition
    heat = vertex_heat if vertex_heat is not None else np.ones(g.n_nodes)
    cross = part[g.src] != part[g.dst]
    # edge count from remote vertex u into shard s, both directions; a
    # (u, s) pair is the key u * n_keys + s, whose order is the pairs'
    # lexicographic order
    n_keys = int(part.max()) + 1 if len(part) else 1
    key_a = g.src[cross].astype(np.int64) * n_keys + part[g.dst[cross]]
    key_b = g.dst[cross].astype(np.int64) * n_keys + part[g.src[cross]]
    uniq, counts = np.unique(np.concatenate([key_a, key_b]), return_counts=True)
    v_ids, s_ids = uniq // n_keys, uniq % n_keys
    reads = counts.astype(np.float64) * heat[v_ids]
    # relative cost units: gather saving ~ n_layers reads; sync ~ write_rate
    gain = n_layers * reads - write_rate - 0.01  # store cost epsilon
    order = np.argsort(-gain)
    budget = int(budget_frac * g.n_nodes / max(n_shards, 1))
    # best gain first, up to the first pair without a positive gain; each
    # shard keeps its first ``budget`` pairs in that order
    stop = np.flatnonzero(gain[order] <= 0)
    take = order[: stop[0] if len(stop) else len(order)]
    by_shard = np.argsort(s_ids[take], kind="stable")
    shard_sorted = s_ids[take][by_shard]
    rank = np.arange(len(take)) - np.searchsorted(shard_sorted, shard_sorted)
    kept = np.sort(take[by_shard[rank < budget]])
    halos = [np.sort(v_ids[kept[s_ids[kept] == s]]).astype(np.int64) for s in range(n_shards)]
    # how many cut edges now have their remote endpoint local?
    resolved = int((np.isin(key_a, uniq[kept]) | np.isin(key_b, uniq[kept])).sum())
    return HaloPlan(
        halo=halos,
        replicated_bytes=float(sum(len(h) for h in halos)) * bytes_per_vertex,
        cut_edges_before=int(cross.sum()),
        cut_edges_resolved=resolved,
    )


def plan_expert_replicas(
    expert_load: np.ndarray,  # [E] router load fractions (DHD heat signal)
    n_shards: int,
    max_replicas: int = 4,
) -> np.ndarray:
    """Replication factor per expert ~ proportional to load (hot experts get
    more replicas, capped).  Returns [E] ints >= 1."""
    e = len(expert_load)
    mean = 1.0 / max(e, 1)
    factor = np.clip(np.round(expert_load / max(mean, 1e-9)), 1, max_replicas)
    return factor.astype(np.int64)


def plan_row_replicas(
    row_freq: np.ndarray,  # [V] access counts
    quantile: float = 0.999,
) -> np.ndarray:
    """Hot embedding rows (above the heat quantile) to replicate across the
    model axis instead of row-sharding (GeoLayer pre-caching at mesh scale)."""
    if row_freq.max() <= 0:
        return np.zeros(0, dtype=np.int64)
    theta = np.quantile(row_freq[row_freq > 0], quantile)
    return np.where(row_freq >= theta)[0]
