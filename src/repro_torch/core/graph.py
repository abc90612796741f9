"""Graph containers and format builders for the GeoLayer store.

The control plane (placement / routing decisions) operates on NumPy arrays;
the data plane (heat diffusion, analytics) consumes the CSR/ELL/COO tensors
produced here as torch tensors.  All structures are immutable-by-convention.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Graph",
    "CSR",
    "ELL",
    "build_csr",
    "build_ell",
    "weakly_connected_components",
    "subgraph_edges",
    "grow_item_rows",
]


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row adjacency.  indptr[n+1], indices[nnz]."""

    indptr: np.ndarray
    indices: np.ndarray
    weights: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded neighbor-list (ELLPACK) adjacency for the DHD kernels.

    ``cols[n, max_deg]`` padded with ``n`` (self-loop sentinel) and
    ``mask[n, max_deg]`` 1.0 for real edges.  An optional COO tail holds
    overflow edges for nodes whose degree exceeds ``max_deg``.
    """

    cols: np.ndarray  # [n, max_deg] int32
    vals: np.ndarray  # [n, max_deg] float32 (edge weight; 0 where padded)
    tail_src: np.ndarray  # [t] int32 overflow COO
    tail_dst: np.ndarray  # [t] int32
    tail_val: np.ndarray  # [t] float32

    @property
    def n_nodes(self) -> int:
        return int(self.cols.shape[0])

    @property
    def max_degree(self) -> int:
        return int(self.cols.shape[1])


@dataclasses.dataclass
class Graph:
    """A (possibly directed) graph with per-item sizes and a geo partition.

    Vertices and edges are both *data items* in the GeoLayer cost model.
    Item ids: vertex v -> v;  edge e (index into ``src``) -> n_nodes + e.
    """

    n_nodes: int
    src: np.ndarray  # [m] int32
    dst: np.ndarray  # [m] int32
    node_size: np.ndarray  # [n] float32, bytes (or normalized units)
    edge_size: np.ndarray  # [m] float32
    partition: np.ndarray  # [n] int32 -> DC id owning the primary copy

    def __post_init__(self) -> None:
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        self.node_size = np.asarray(self.node_size, dtype=np.float32)
        self.edge_size = np.asarray(self.edge_size, dtype=np.float32)
        self.partition = np.asarray(self.partition, dtype=np.int32)

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_items(self) -> int:
        return self.n_nodes + self.n_edges

    def item_size(self) -> np.ndarray:
        return np.concatenate([self.node_size, self.edge_size])

    def edge_item_id(self, e: np.ndarray) -> np.ndarray:
        return np.asarray(e) + self.n_nodes

    def is_cross_edge(self) -> np.ndarray:
        """Boolean mask of edges whose endpoints live in different DCs."""
        return self.partition[self.src] != self.partition[self.dst]

    def edge_dc_pair(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.partition[self.src], self.partition[self.dst]

    @staticmethod
    def from_edges(
        n_nodes: int,
        src: Sequence[int],
        dst: Sequence[int],
        partition: Sequence[int],
        node_size: Optional[Sequence[float]] = None,
        edge_size: Optional[Sequence[float]] = None,
    ) -> "Graph":
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        m = src.shape[0]
        if node_size is None:
            node_size = np.ones(n_nodes, dtype=np.float32)
        if edge_size is None:
            edge_size = np.ones(m, dtype=np.float32)
        return Graph(
            n_nodes=n_nodes,
            src=src,
            dst=dst,
            node_size=np.asarray(node_size, dtype=np.float32),
            edge_size=np.asarray(edge_size, dtype=np.float32),
            partition=np.asarray(partition, dtype=np.int32),
        )


def build_csr(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    weights: Optional[np.ndarray] = None,
    symmetrize: bool = False,
) -> CSR:
    """Build CSR from an edge list; optionally add reverse edges."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if weights is not None:
            weights = np.concatenate([weights, weights])
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    counts = np.bincount(src_s, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    w = weights[order].astype(np.float32) if weights is not None else None
    return CSR(indptr=indptr, indices=dst_s.astype(np.int32), weights=w)


def build_ell(
    csr: CSR,
    max_degree: Optional[int] = None,
    degree_quantile: float = 0.98,
) -> ELL:
    """Pack a CSR into ELL with a COO tail for overflow (power-law safe).

    ``max_degree`` defaults to the ``degree_quantile`` of the degree
    distribution, rounded up to a multiple of 8 (VPU lane friendliness).
    """
    n = csr.n_nodes
    deg = csr.degree()
    if max_degree is None:
        q = int(np.quantile(deg, degree_quantile)) if n else 1
        max_degree = max(8, int(np.ceil(max(q, 1) / 8.0)) * 8)
    cols = np.full((n, max_degree), fill_value=np.arange(n)[:, None], dtype=np.int32)
    vals = np.zeros((n, max_degree), dtype=np.float32)
    tail_src: List[int] = []
    tail_dst: List[int] = []
    tail_val: List[float] = []
    w = csr.weights if csr.weights is not None else np.ones(csr.n_edges, np.float32)
    for u in range(n):
        lo, hi = int(csr.indptr[u]), int(csr.indptr[u + 1])
        k = hi - lo
        take = min(k, max_degree)
        cols[u, :take] = csr.indices[lo : lo + take]
        vals[u, :take] = w[lo : lo + take]
        if k > max_degree:
            tail_src.extend([u] * (k - max_degree))
            tail_dst.extend(csr.indices[lo + max_degree : hi].tolist())
            tail_val.extend(w[lo + max_degree : hi].tolist())
    return ELL(
        cols=cols,
        vals=vals,
        tail_src=np.asarray(tail_src, dtype=np.int32),
        tail_dst=np.asarray(tail_dst, dtype=np.int32),
        tail_val=np.asarray(tail_val, dtype=np.float32),
    )


def weakly_connected_components(
    n_nodes: int, src: np.ndarray, dst: np.ndarray
) -> np.ndarray:
    """Label weakly connected components via union-find.  Returns [n] labels
    renumbered to 0..k-1 (order of first appearance)."""
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(a: int) -> int:
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:  # path compression
            parent[a], a = root, parent[a]
        return root

    for u, v in zip(np.asarray(src).tolist(), np.asarray(dst).tolist()):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    labels = np.fromiter((find(i) for i in range(n_nodes)), dtype=np.int64, count=n_nodes)
    _, renum = np.unique(labels, return_inverse=True)
    return renum.astype(np.int32)


def subgraph_edges(g: Graph, edge_mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Return (src, dst) of the edges selected by ``edge_mask``."""
    return g.src[edge_mask], g.dst[edge_mask]


def grow_item_rows(
    a: np.ndarray, old_n_nodes: int, n_new_vertices: int, n_new_edges: int, fill
) -> np.ndarray:
    """Grow an item-indexed array for a mutation batch, preserving the
    ``vertex v -> v, edge e -> n_nodes + e`` id layout: new-vertex rows are
    inserted *mid* (end of the vertex block, shifting every edge item id by
    ``n_new_vertices``) and new-edge rows appended at the end.

    This is the single encoding of the id-space shift — placement rows, the
    route index and heat caches must all grow through it so their rows stay
    aligned.  Works for 1-D ([I] fields) and 2-D ([I, D] tables) arrays.
    """
    tail = a.shape[1:]
    mid = np.full((n_new_vertices, *tail), fill, dtype=a.dtype)
    end = np.full((n_new_edges, *tail), fill, dtype=a.dtype)
    return np.concatenate([a[:old_n_nodes], mid, a[old_n_nodes:], end])
