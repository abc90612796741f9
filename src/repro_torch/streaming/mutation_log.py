"""Mutation batching and the delta-CSR overlay (streaming tentpole, part 1).

Design: the base graph's arrays are append-only with *stable ids* — new
vertices and edges take fresh ids at the end of their ranges, deletes are
tombstones (``node_alive`` / ``edge_alive`` masks).  The control plane keeps
operating on the overlay without rewriting the base CSR; ``DeltaGraph.compact``
produces a dense re-numbered :class:`~repro_torch.core.graph.Graph` (plus the id
maps) when a full rebuild or a from-scratch validation is wanted.

Item-id convention (unchanged from ``core.graph``): vertex v -> v, edge e ->
``n_nodes + e``.  Because vertex appends grow ``n_nodes``, every *edge* item
id shifts by the number of new vertices per batch; :func:`ApplyResult.remap_items`
is the single place that encodes this shift for placement/workload arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.graph import Graph
from ..core.patterns import Pattern, Workload

__all__ = [
    "MutationBatch",
    "MutationLog",
    "DeltaCSR",
    "ApplyResult",
    "DeltaGraph",
    "random_churn_batch",
    "compact_workload",
]


@dataclasses.dataclass
class MutationBatch:
    """One sealed batch of topology mutations (arrays, not per-op objects).

    ``add_edge_src/dst`` may reference provisional vertex ids
    ``old_n_nodes + j`` for the j-th vertex added in the same batch.
    """

    add_vertex_size: np.ndarray  # [nv] float32
    add_vertex_partition: np.ndarray  # [nv] int32
    del_vertex_ids: np.ndarray  # [dv] int64
    add_edge_src: np.ndarray  # [ne] int64
    add_edge_dst: np.ndarray  # [ne] int64
    add_edge_size: np.ndarray  # [ne] float32
    del_edge_ids: np.ndarray  # [de] int64

    @staticmethod
    def empty() -> "MutationBatch":
        return MutationBatch(
            add_vertex_size=np.zeros(0, np.float32),
            add_vertex_partition=np.zeros(0, np.int32),
            del_vertex_ids=np.zeros(0, np.int64),
            add_edge_src=np.zeros(0, np.int64),
            add_edge_dst=np.zeros(0, np.int64),
            add_edge_size=np.zeros(0, np.float32),
            del_edge_ids=np.zeros(0, np.int64),
        )

    @property
    def n_ops(self) -> int:
        return (
            len(self.add_vertex_size) + len(self.del_vertex_ids)
            + len(self.add_edge_src) + len(self.del_edge_ids)
        )


class MutationLog:
    """Accumulates single mutations; ``seal()`` emits a :class:`MutationBatch`.

    ``add_vertex`` returns the provisional id the vertex will take once the
    batch is applied, so callers can wire new edges to new vertices within
    one batch.
    """

    def __init__(self, n_nodes: int) -> None:
        self._n_base = n_nodes
        self._reset()

    def _reset(self) -> None:
        self._av_size: List[float] = []
        self._av_part: List[int] = []
        self._dv: List[int] = []
        self._ae: List[Tuple[int, int, float]] = []
        self._de: List[int] = []

    def __len__(self) -> int:
        return len(self._av_size) + len(self._dv) + len(self._ae) + len(self._de)

    def add_vertex(self, partition: int, size: float = 1.0) -> int:
        vid = self._n_base + len(self._av_size)
        self._av_size.append(float(size))
        self._av_part.append(int(partition))
        return vid

    def delete_vertex(self, vid: int) -> None:
        self._dv.append(int(vid))

    def add_edge(self, src: int, dst: int, size: float = 1.0) -> None:
        self._ae.append((int(src), int(dst), float(size)))

    def delete_edge(self, eid: int) -> None:
        self._de.append(int(eid))

    def seal(self) -> MutationBatch:
        batch = MutationBatch(
            add_vertex_size=np.asarray(self._av_size, np.float32),
            add_vertex_partition=np.asarray(self._av_part, np.int32),
            del_vertex_ids=np.asarray(sorted(set(self._dv)), np.int64),
            add_edge_src=np.asarray([e[0] for e in self._ae], np.int64),
            add_edge_dst=np.asarray([e[1] for e in self._ae], np.int64),
            add_edge_size=np.asarray([e[2] for e in self._ae], np.float32),
            del_edge_ids=np.asarray(sorted(set(self._de)), np.int64),
        )
        self._n_base += len(self._av_size)
        self._reset()
        return batch


# ------------------------------------------------------------------ DeltaCSR
class DeltaCSR:
    """CSR + append/tombstone overlay; adjacency queries without CSR rewrite.

    The base is CSR-shaped (indptr/indices) with a parallel exact int64
    edge-id column, so deletions resolve against the live mask.  Added edges
    live in per-vertex Python lists — O(1) amortized append — and ``merge()``
    folds everything into a fresh base when the overlay grows past
    ``merge_threshold`` of the base size.
    """

    def __init__(
        self,
        n_nodes: int,
        src: np.ndarray,
        dst: np.ndarray,
        edge_ids: Optional[np.ndarray] = None,
        merge_threshold: float = 0.5,
    ) -> None:
        if edge_ids is None:
            edge_ids = np.arange(len(src), dtype=np.int64)
        self.n_nodes = int(n_nodes)
        self._build_base(src, dst, edge_ids)
        self.merge_threshold = merge_threshold
        self._extra_dst: Dict[int, List[int]] = {}
        self._extra_eid: Dict[int, List[int]] = {}
        self._n_extra_edges = 0

    def _build_base(self, src: np.ndarray, dst: np.ndarray, edge_ids: np.ndarray) -> None:
        """CSR-shaped base with an exact int64 edge-id column (CSR.weights is
        float32, which would corrupt edge ids beyond 2^24)."""
        src = np.asarray(src, np.int64)
        order = np.argsort(src, kind="stable")
        counts = np.bincount(src[order], minlength=self.n_nodes)
        self._base_indptr = np.zeros(self.n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=self._base_indptr[1:])
        self._base_indices = np.asarray(dst, np.int64)[order]
        self._base_eids = np.asarray(edge_ids, np.int64)[order]
        self._base_n_nodes = self.n_nodes

    def add_node(self) -> int:
        self.n_nodes += 1
        return self.n_nodes - 1

    def add_edge(self, u: int, v: int, eid: int) -> None:
        self._extra_dst.setdefault(int(u), []).append(int(v))
        self._extra_eid.setdefault(int(u), []).append(int(eid))
        self._n_extra_edges += 1

    def out_edges(self, u: int, edge_alive: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(neighbor ids, edge ids) of u's alive out-edges (base + overlay)."""
        if u < self._base_n_nodes:
            lo, hi = int(self._base_indptr[u]), int(self._base_indptr[u + 1])
            nbr = self._base_indices[lo:hi]
            eid = self._base_eids[lo:hi]
        else:  # vertex appended after the base was built
            nbr = np.zeros(0, np.int64)
            eid = np.zeros(0, np.int64)
        if u in self._extra_dst:
            nbr = np.concatenate([nbr, np.asarray(self._extra_dst[u], np.int64)])
            eid = np.concatenate([eid, np.asarray(self._extra_eid[u], np.int64)])
        keep = edge_alive[eid]
        return nbr[keep], eid[keep]

    def needs_merge(self) -> bool:
        return self._n_extra_edges > self.merge_threshold * max(len(self._base_indices), 1)

    def merge(self, src: np.ndarray, dst: np.ndarray, edge_alive: np.ndarray) -> None:
        """Fold the overlay into a fresh base CSR over the alive edges."""
        eids = np.where(edge_alive)[0]
        self._build_base(src[eids], dst[eids], eids)
        self._extra_dst.clear()
        self._extra_eid.clear()
        self._n_extra_edges = 0


# ---------------------------------------------------------------- DeltaGraph
@dataclasses.dataclass
class ApplyResult:
    """Everything downstream consumers need to absorb one batch."""

    old_n_nodes: int
    old_n_edges: int
    n_new_vertices: int
    new_vertex_ids: np.ndarray  # ids in the *new* numbering
    new_edge_ids: np.ndarray  # edge indices (stable)
    dead_vertex_ids: np.ndarray  # vertices tombstoned by this batch
    dead_edge_ids: np.ndarray  # edges tombstoned (incl. vertex cascades)
    touched_vertices: np.ndarray  # alive endpoints of all mutated edges + new

    def remap_items(self, item_ids: np.ndarray) -> np.ndarray:
        """Old item ids -> new item ids (edge block shifts by new vertices)."""
        item_ids = np.asarray(item_ids)
        return np.where(
            item_ids < self.old_n_nodes, item_ids, item_ids + self.n_new_vertices
        )

    def dead_item_ids(self, new_n_nodes: int) -> np.ndarray:
        """Tombstoned item ids in the new numbering."""
        return np.concatenate(
            [self.dead_vertex_ids, new_n_nodes + self.dead_edge_ids]
        ).astype(np.int64)

    def new_item_ids(self, new_n_nodes: int) -> np.ndarray:
        return np.concatenate(
            [self.new_vertex_ids, new_n_nodes + self.new_edge_ids]
        ).astype(np.int64)


class DeltaGraph:
    """Stable-id mutable view over a :class:`~repro_torch.core.graph.Graph`.

    ``g`` always reflects the latest applied batch (arrays re-concatenated per
    batch — O(n + m) numpy copies, no Python loops); ``node_alive`` /
    ``edge_alive`` carry the tombstones; ``adj`` is the delta-CSR overlay used
    for adjacency queries without rebuilding.
    """

    def __init__(self, g: Graph) -> None:
        self.g = g
        self.node_alive = np.ones(g.n_nodes, dtype=bool)
        self.edge_alive = np.ones(g.n_edges, dtype=bool)
        self.adj = DeltaCSR(g.n_nodes, g.src, g.dst)
        # reverse overlay for undirected incidence queries
        self.radj = DeltaCSR(g.n_nodes, g.dst, g.src)

    @staticmethod
    def from_graph(g: Graph) -> "DeltaGraph":
        return DeltaGraph(g)

    # ------------------------------------------------------------- queries
    def incident_edges(self, u: int) -> np.ndarray:
        """Alive edge ids touching ``u`` (either direction)."""
        _, out_e = self.adj.out_edges(u, self.edge_alive)
        _, in_e = self.radj.out_edges(u, self.edge_alive)
        return np.unique(np.concatenate([out_e, in_e]))

    def undirected_neighbors(self, u: int) -> np.ndarray:
        out_n, _ = self.adj.out_edges(u, self.edge_alive)
        in_n, _ = self.radj.out_edges(u, self.edge_alive)
        return np.unique(np.concatenate([out_n, in_n]))

    @property
    def n_alive_edges(self) -> int:
        return int(self.edge_alive.sum())

    @property
    def n_alive_nodes(self) -> int:
        return int(self.node_alive.sum())

    # --------------------------------------------------------------- apply
    def apply(self, batch: MutationBatch) -> ApplyResult:
        g = self.g
        old_n, old_m = g.n_nodes, g.n_edges
        nv = len(batch.add_vertex_size)
        ne = len(batch.add_edge_src)

        # --- grow vertex arrays ------------------------------------------
        n2 = old_n + nv
        node_size = np.concatenate([g.node_size, batch.add_vertex_size])
        partition = np.concatenate([g.partition, batch.add_vertex_partition])
        node_alive = np.concatenate([self.node_alive, np.ones(nv, bool)])

        # --- append edges (endpoints may reference provisional ids) ------
        if ne:
            if (batch.add_edge_src >= n2).any() or (batch.add_edge_dst >= n2).any():
                raise ValueError("add_edge references an unknown vertex id")
            alive_before = np.concatenate([self.node_alive, np.ones(nv, bool)])
            if (~alive_before[batch.add_edge_src]).any() or (
                ~alive_before[batch.add_edge_dst]
            ).any():
                raise ValueError("add_edge references a deleted vertex")
        src = np.concatenate([g.src, batch.add_edge_src.astype(np.int32)])
        dst = np.concatenate([g.dst, batch.add_edge_dst.astype(np.int32)])
        edge_size = np.concatenate([g.edge_size, batch.add_edge_size])
        edge_alive = np.concatenate([self.edge_alive, np.ones(ne, bool)])
        new_edge_ids = old_m + np.arange(ne, dtype=np.int64)

        # --- tombstones ---------------------------------------------------
        del_e = batch.del_edge_ids
        if len(del_e):
            if (del_e >= old_m).any():
                raise ValueError("delete_edge references an unknown edge id")
            edge_alive[del_e] = False
        dead_v = batch.del_vertex_ids
        if len(dead_v):
            # provisional ids (vertices added in this same batch) are legal
            # delete targets; only ids beyond the post-batch range are unknown
            if (dead_v >= n2).any():
                raise ValueError("delete_vertex references an unknown vertex id")
            node_alive[dead_v] = False
            dead_v_mask = np.zeros(n2, dtype=bool)
            dead_v_mask[dead_v] = True
            cascade = edge_alive & (dead_v_mask[src] | dead_v_mask[dst])
        else:
            cascade = np.zeros(len(src), dtype=bool)
        edge_alive &= ~cascade
        dead_edges = np.unique(
            np.concatenate([del_e, np.where(cascade)[0]])
        ).astype(np.int64)
        # an edge both added and cascade-killed in one batch stays dead
        dead_edges = dead_edges[dead_edges < old_m + ne]

        # --- commit -------------------------------------------------------
        self.g = Graph(
            n_nodes=n2,
            src=src,
            dst=dst,
            node_size=node_size,
            edge_size=edge_size,
            partition=partition,
        )
        self.node_alive = node_alive
        self.edge_alive = edge_alive
        for _ in range(nv):
            self.adj.add_node()
            self.radj.add_node()
        for j in range(ne):
            u, v = int(batch.add_edge_src[j]), int(batch.add_edge_dst[j])
            eid = int(old_m + j)
            self.adj.add_edge(u, v, eid)
            self.radj.add_edge(v, u, eid)
        if self.adj.needs_merge():
            self.adj.merge(src, dst, edge_alive)
            self.radj.merge(dst, src, edge_alive)

        # --- touched frontier --------------------------------------------
        mut_e = np.concatenate([new_edge_ids, dead_edges]).astype(np.int64)
        endpoints = np.concatenate([src[mut_e], dst[mut_e]]) if len(mut_e) else np.zeros(0, np.int64)
        # dead vertices stay in the touched set: downstream consumers (e.g.
        # the warm DHD ELL) must clear their rows, not skip them
        new_vids = old_n + np.arange(nv, dtype=np.int64)
        touched = np.unique(np.concatenate([endpoints, new_vids, dead_v]))

        return ApplyResult(
            old_n_nodes=old_n,
            old_n_edges=old_m,
            n_new_vertices=nv,
            new_vertex_ids=new_vids,
            new_edge_ids=new_edge_ids,
            dead_vertex_ids=np.asarray(dead_v, np.int64),
            dead_edge_ids=dead_edges,
            touched_vertices=touched.astype(np.int64),
        )

    # ------------------------------------------------------------- compact
    def compact(self) -> Tuple[Graph, np.ndarray, np.ndarray]:
        """Dense re-numbered graph over alive vertices/edges.

        Returns (graph, vmap, emap): ``vmap[old_vertex] -> new id or -1``,
        ``emap[old_edge] -> new id or -1``.
        """
        vkeep = np.where(self.node_alive)[0]
        vmap = np.full(self.g.n_nodes, -1, dtype=np.int64)
        vmap[vkeep] = np.arange(len(vkeep))
        ekeep = np.where(self.edge_alive)[0]
        emap = np.full(self.g.n_edges, -1, dtype=np.int64)
        emap[ekeep] = np.arange(len(ekeep))
        g = Graph(
            n_nodes=len(vkeep),
            src=vmap[self.g.src[ekeep]].astype(np.int32),
            dst=vmap[self.g.dst[ekeep]].astype(np.int32),
            node_size=self.g.node_size[vkeep],
            edge_size=self.g.edge_size[ekeep],
            partition=self.g.partition[vkeep],
        )
        return g, vmap, emap


def compact_workload(
    wl: Workload, old_n_nodes: int, gc: Graph, vmap: np.ndarray, emap: np.ndarray
) -> Workload:
    """Re-key a workload onto a :meth:`DeltaGraph.compact` graph.

    Dead items are dropped from every pattern; frequencies are re-aggregated.
    This is what a from-scratch rebuild consumes, so incremental-vs-rebuild
    comparisons evaluate the same logical workload.
    """
    pats: List[Pattern] = []
    for p in wl.patterns:
        vi = p.items[p.items < old_n_nodes]
        ei = p.items[p.items >= old_n_nodes] - old_n_nodes
        v2 = vmap[vi]
        e2 = emap[ei]
        items = np.concatenate([v2[v2 >= 0], gc.n_nodes + e2[e2 >= 0]])
        pats.append(
            Pattern(pid=p.pid, items=np.sort(items), r_py=p.r_py, w_py=p.w_py, eta=p.eta)
        )
    return Workload.from_patterns(pats, gc.n_items, wl.n_dcs)


# ----------------------------------------------------------------- churn gen
def random_churn_batch(
    dg: DeltaGraph,
    rate: float,
    rng: np.random.Generator,
    vertex_fraction: float = 0.1,
) -> MutationBatch:
    """A mixed mutation batch touching ~``rate`` of the alive edges.

    Composition mirrors social-graph churn: mostly edge births/deaths between
    existing vertices, a thin stream of vertex arrivals (wired to random
    alive vertices) and departures (cascading their incident edges).
    """
    g = dg.g
    alive_v = np.where(dg.node_alive)[0]
    alive_e = np.where(dg.edge_alive)[0]
    n_e = max(1, int(rate * len(alive_e)))
    n_v = max(1, int(vertex_fraction * n_e))
    log = MutationLog(g.n_nodes)

    # vertex arrivals, each wired with 1-3 edges
    for _ in range(n_v):
        dc = int(rng.integers(0, int(g.partition.max()) + 1))
        vid = log.add_vertex(partition=dc, size=1.0)
        for _ in range(int(rng.integers(1, 4))):
            peer = int(rng.choice(alive_v))
            if rng.random() < 0.5:
                log.add_edge(vid, peer)
            else:
                log.add_edge(peer, vid)

    # edge births between existing vertices
    for _ in range(n_e):
        u, v = rng.choice(alive_v, size=2, replace=False)
        log.add_edge(int(u), int(v))

    # edge deaths
    for eid in rng.choice(alive_e, size=min(n_e, len(alive_e)), replace=False):
        log.delete_edge(int(eid))

    # vertex departures
    if len(alive_v) > 8 * n_v:
        for vid in rng.choice(alive_v, size=n_v, replace=False):
            log.delete_vertex(int(vid))

    return log.seal()
