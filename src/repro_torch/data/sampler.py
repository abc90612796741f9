"""Fanout neighbor sampler for sampled GNN training (``minibatch_lg``).

GraphSAGE-style layered sampling over CSR: for each seed node draw up to
``fanout[i]`` neighbors at hop i, emitting a padded block a train step
consumes with static shapes.  Runs host-side (data pipeline), NumPy only.

A copy of ``repro/data/sampler.py`` over the port's own
:class:`repro_torch.core.graph.CSR`; the same seed draws the same blocks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from ..core.graph import CSR

__all__ = ["SampledBlock", "NeighborSampler"]


@dataclasses.dataclass
class SampledBlock:
    """Padded k-hop block. Shapes are static given (batch, fanouts).

    node_ids:  [n_max] global ids of all sampled nodes (padded with 0)
    node_mask: [n_max] validity
    edge_src/edge_dst: [e_max] indices *into node_ids* (padded self-loops)
    edge_mask: [e_max]
    seeds:     [batch] positions of the seed nodes in node_ids (0..batch-1)
    """

    node_ids: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    seeds: np.ndarray

    @property
    def n_max(self) -> int:
        return int(self.node_ids.shape[0])

    @property
    def e_max(self) -> int:
        return int(self.edge_src.shape[0])


def block_capacity(batch: int, fanouts: Sequence[int]) -> Tuple[int, int]:
    """Static (n_max, e_max) for a given batch + fanout schedule."""
    n_max = batch
    e_max = 0
    frontier = batch
    for f in fanouts:
        e_max += frontier * f
        frontier = frontier * f
        n_max += frontier
    return n_max, e_max


class NeighborSampler:
    def __init__(self, csr: CSR, fanouts: Sequence[int], seed: int = 0) -> None:
        self.csr = csr
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> SampledBlock:
        batch = len(seeds)
        n_max, e_max = block_capacity(batch, self.fanouts)
        node_ids = np.zeros(n_max, dtype=np.int64)
        node_mask = np.zeros(n_max, dtype=bool)
        edge_src = np.zeros(e_max, dtype=np.int32)
        edge_dst = np.zeros(e_max, dtype=np.int32)
        edge_mask = np.zeros(e_max, dtype=bool)

        node_ids[:batch] = seeds
        node_mask[:batch] = True
        pos = {int(v): i for i, v in enumerate(seeds)}
        n_ptr = batch
        e_ptr = 0
        frontier = list(range(batch))  # positions of current frontier
        for f in self.fanouts:
            nxt: List[int] = []
            for fp in frontier:
                u = int(node_ids[fp])
                lo, hi = int(self.csr.indptr[u]), int(self.csr.indptr[u + 1])
                deg = hi - lo
                if deg == 0:
                    continue
                k = min(f, deg)
                sel = self.rng.choice(deg, size=k, replace=False)
                for s in sel:
                    v = int(self.csr.indices[lo + s])
                    if v not in pos:
                        pos[v] = n_ptr
                        node_ids[n_ptr] = v
                        node_mask[n_ptr] = True
                        nxt.append(n_ptr)
                        n_ptr += 1
                    # message edge: neighbor -> frontier node
                    edge_src[e_ptr] = pos[v]
                    edge_dst[e_ptr] = fp
                    edge_mask[e_ptr] = True
                    e_ptr += 1
            frontier = nxt
            if not frontier:
                break
        return SampledBlock(
            node_ids=node_ids,
            node_mask=node_mask,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_mask=edge_mask,
            seeds=np.arange(batch, dtype=np.int32),
        )
