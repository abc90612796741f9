"""Halo-exchange message passing over the shards' devices — the *measured*
realization of the GeoLayer placement win for distributed GNNs.

Port of ``repro/distributed/halo_exec.py``.  Baseline distributed message
passing all-gathers the full feature matrix every layer: wire = (P-1)/P * N
* d * bytes per layer.  The halo executor instead exchanges only the rows
other shards actually need, with *static* send lists planned from the graph
cut (``plan_gnn_halo`` picks which remote rows are worth keeping resident):

    per layer:  send_rows = feats[send_idx]        # [P, S_max, d]
                recv_rows = all_to_all(send_rows)  # the halo exchange
                ext = concat([feats_local, recv_rows.reshape(-1, d)])
                msgs -> segment_sum over local edges

wire = P * S_max * d * bytes per layer, with S_max = max rows any shard
exports ≈ boundary size.  The wire ratio vs baseline is measured by
:func:`exchange_stats` (exact byte accounting, no model).

Where the JAX package runs one ``shard_map`` program over a mesh with
``all_to_all`` / ``all_gather``, the port holds each shard's block on its
device (``geo_sharding.mesh_devices``) and moves every exchanged block with
``collectives.transfer_rows``, which reports the bytes that crossed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import Graph
from .collectives import transfer_rows

__all__ = ["HaloProgram", "build_halo_program", "run_message_passing", "exchange_stats"]


@dataclasses.dataclass
class HaloProgram:
    """Static plan for halo message passing over a partition.

    All arrays have a leading shard axis [P, ...] (padded, masked):
      send_idx  [P, P, s_max]  rows of shard p to ship to shard q (local ids)
      send_mask [P, P, s_max]
      edge_src  [P, e_max]     index into [local n_max ++ recv (P*s_max)]
      edge_dst  [P, e_max]     local destination index
      edge_mask [P, e_max]
      feats     [P, n_max, d]  built by ``scatter_features``
    """

    n_shards: int
    n_max: int
    s_max: int
    e_max: int
    send_idx: np.ndarray
    send_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    local_ids: List[np.ndarray]  # global vertex ids per shard (unpadded)

    def scatter_features(self, feats_global: np.ndarray) -> np.ndarray:
        d = feats_global.shape[1]
        out = np.zeros((self.n_shards, self.n_max, d), feats_global.dtype)
        for p, ids in enumerate(self.local_ids):
            out[p, : len(ids)] = feats_global[ids]
        return out

    def gather_outputs(self, out_sharded: np.ndarray, n_global: int) -> np.ndarray:
        d = out_sharded.shape[-1]
        out = np.zeros((n_global, d), out_sharded.dtype)
        for p, ids in enumerate(self.local_ids):
            out[ids] = out_sharded[p, : len(ids)]
        return out

    def place(self, devices: Sequence) -> List[Dict[str, torch.Tensor]]:
        """Each shard's static arrays on its device: the rows it ships to
        each shard (``send_rows[q]``), the masks of the rows it receives
        from each shard (``recv_mask`` [P, s_max]) and the rows each shard
        ships to it (``rows_from`` [P, s_max], for the all-gather), its
        edges and their in-degrees."""
        out = []
        for p, dev in enumerate(devices):
            on = lambda a, dt=torch.int64: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
            e_dst = on(self.edge_dst[p])
            e_mask = on(self.edge_mask[p], torch.bool)
            deg = torch.zeros(self.n_max, device=dev).index_add_(0, e_dst, e_mask.float())
            out.append({
                "send_rows": [on(self.send_idx[p, q]) for q in range(self.n_shards)],
                "recv_mask": on(self.send_mask[:, p], torch.bool),
                "rows_from": on(self.send_idx[:, p]),
                "edge_src": on(self.edge_src[p]),
                "edge_dst": e_dst,
                "edge_mask": e_mask,
                "deg": deg.clamp_min(1.0)[:, None],
            })
        return out


def build_halo_program(g: Graph, n_shards: int) -> HaloProgram:
    """Plan send lists + local edge index from a partitioned graph.

    Edges are owned by their dst's shard; src rows on other shards enter the
    shard's receive buffer at a deterministic slot (q * s_max + position in
    q's send list to us).  The JAX package builds the same arrays with a
    loop over the edges; here each step is a numpy pass: a send list holds
    its distinct source vertices in the order of their first cross edge,
    and a shard's edges keep the graph's edge order."""
    part = np.asarray(g.partition).astype(np.int64)
    local_ids = [np.where(part == p)[0] for p in range(n_shards)]
    local = np.zeros(g.n_nodes, np.int64)  # global id -> index in its shard
    for ids in local_ids:
        local[ids] = np.arange(len(ids))
    n_max = max(len(i) for i in local_ids)
    src = np.asarray(g.src, np.int64)
    dst = np.asarray(g.dst, np.int64)
    ps, pq = part[src], part[dst]

    # who needs what: shard q needs src rows owned by p for q's edges; one
    # send slot per distinct (p, q, src), numbered by first appearance
    cross = np.flatnonzero(ps != pq)
    key = (ps[cross] * n_shards + pq[cross]) * g.n_nodes + src[cross]
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    pair = uniq // g.n_nodes  # p * P + q
    order = np.lexsort((first, pair))
    pair_sorted = pair[order]
    slot = np.empty(len(uniq), np.int64)
    slot[order] = np.arange(len(uniq)) - np.searchsorted(pair_sorted, pair_sorted)
    s_max = int(np.bincount(pair).max()) if len(uniq) else 1

    send_idx = np.zeros((n_shards, n_shards, s_max), np.int32)
    send_mask = np.zeros((n_shards, n_shards, s_max), bool)
    send_idx[pair // n_shards, pair % n_shards, slot] = local[uniq % g.n_nodes]
    send_mask[pair // n_shards, pair % n_shards, slot] = True

    counts = np.bincount(pq, minlength=n_shards)
    e_max = int(counts.max()) if len(counts) else 1
    by_shard = np.argsort(pq, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    fill = np.empty(len(src), np.int64)
    fill[by_shard] = np.arange(len(src)) - starts[pq[by_shard]]
    e_src = local[src]
    # halo row: offset past the local block, at the sender's receive slot
    e_src[cross] = n_max + ps[cross] * s_max + slot[inv.reshape(-1)]
    edge_src = np.zeros((n_shards, e_max), np.int32)
    edge_dst = np.zeros((n_shards, e_max), np.int32)
    edge_mask = np.zeros((n_shards, e_max), bool)
    edge_src[pq, fill] = e_src
    edge_dst[pq, fill] = local[dst]
    edge_mask[pq, fill] = True
    return HaloProgram(
        n_shards=n_shards, n_max=n_max, s_max=s_max, e_max=e_max,
        send_idx=send_idx, send_mask=send_mask,
        edge_src=edge_src, edge_dst=edge_dst, edge_mask=edge_mask,
        local_ids=local_ids,
    )


def run_message_passing(
    prog: HaloProgram,
    devices: Sequence,  # one device a shard (``geo_sharding.mesh_devices``)
    feats,  # [P, n_max, d] (scatter_features layout) or P blocks [n_max, d]
    weights: torch.Tensor,  # [d, d] shared message transform (demo layer)
    n_layers: int = 2,
    mode: str = "halo",  # halo | allgather
    placed: List[Dict[str, torch.Tensor]] = None,
) -> Tuple[List[torch.Tensor], float]:
    """n_layers of mean-aggregated message passing, halo vs all-gather;
    returns each shard's [n_max, d] block on its device and the bytes that
    crossed between shards (``transfer_rows``' count).  ``placed`` is
    :meth:`HaloProgram.place`'s result for ``devices``, made here when None.

    Both modes compute identical results (tested); they differ only in the
    exchange, i.e. the wire bytes.  In halo mode every shard ships its
    padded [s_max, d] send block to every shard (itself too, as
    ``all_to_all`` does); in allgather mode every shard's [n_max, d] block
    crosses to every other shard, which then picks the rows it needs."""
    if mode not in ("halo", "allgather"):
        raise ValueError(f"unknown mode {mode!r} (halo or allgather)")
    n_sh, d = prog.n_shards, int(weights.shape[-1])
    devices = list(devices)
    placed = placed if placed is not None else prog.place(devices)
    w = [weights.to(dev) for dev in devices]
    x = [f.to(dev) for f, dev in zip(feats, devices)]
    all_rows = [torch.arange(prog.n_max, device=dev) for dev in devices]
    wire = 0.0
    for _ in range(n_layers):
        recv = [[None] * n_sh for _ in range(n_sh)]  # recv[q][p]: p's rows at q
        for p in range(n_sh):
            for q in range(n_sh):
                if mode == "halo":
                    blk, nbytes = transfer_rows(x[p], placed[p]["send_rows"][q], devices[q])
                elif p == q:
                    blk, nbytes = x[p], 0.0
                else:
                    blk, nbytes = transfer_rows(x[p], all_rows[p], devices[q])
                recv[q][p] = blk
                wire += nbytes
        new = []
        for q in range(n_sh):
            sq = placed[q]
            if mode == "halo":
                got = torch.where(sq["recv_mask"][..., None], torch.stack(recv[q]), 0.0)
            else:  # emulate the recv layout from the gathered blocks
                got = torch.stack([recv[q][p][sq["rows_from"][p]] for p in range(n_sh)])
            ext = torch.cat([x[q], got.reshape(n_sh * prog.s_max, d)])
            msg = ext[sq["edge_src"]] @ w[q]
            msg = torch.where(sq["edge_mask"][:, None], msg, 0.0)
            agg = torch.zeros_like(x[q]).index_add_(0, sq["edge_dst"], msg)
            new.append(x[q] + torch.tanh(agg / sq["deg"]))
        x = new
    return x, wire


def exchange_stats(prog: HaloProgram, d: int, n_layers: int, bytes_per: int = 4):
    """Exact wire bytes per device per step for both modes."""
    halo = n_layers * prog.n_shards * prog.s_max * d * bytes_per
    allgather = (
        n_layers * (prog.n_shards - 1) * prog.n_max * d * bytes_per
    )
    return {
        "halo_bytes_per_device": halo,
        "allgather_bytes_per_device": allgather,
        "reduction": allgather / max(halo, 1),
    }
