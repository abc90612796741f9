"""Latency-aware layered graph (paper §IV, Definitions 1-2).

* ``Layer_0``      : per-DC local subgraphs (disjoint partition of G).
* ``Layer_i`` i>=1 : bridge graphs of cross-partition edges whose inter-DC
                     latency falls in the bucket [t_{i-1}, t_i).
* Bridge subgraph  : the subset of a layer's edges that merges a set of
                     weakly-connected components of everything below into one
                     component; the merged lower components form its *cluster*.

The hierarchy is a tree over (layer, component) nodes; placement and routing
decisions are confined to branches of this tree (paper App. C(i)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import Graph, weakly_connected_components
from .latency import GeoEnvironment

__all__ = [
    "BridgeSubgraph",
    "LayeredGraph",
    "build_layered_graph",
    "RepairStats",
    "repair_layered_graph",
]


@dataclasses.dataclass
class BridgeSubgraph:
    """One bridge subgraph (Def. 2): intra-layer edge set merging a cluster."""

    layer: int
    bs_id: int  # globally unique
    comp: int  # component id at ``layer`` this BS produced
    edge_ids: np.ndarray  # indices into Graph.src/dst
    children: List[int]  # component ids at layer-1 merged by this BS
    dcs: np.ndarray  # all DCs covered by the merged component

    @property
    def n_dcs(self) -> int:
        return int(len(self.dcs))


@dataclasses.dataclass
class LayeredGraph:
    g: Graph
    env: GeoEnvironment
    thresholds_s: List[float]  # t_1 .. t_{h-1}  (t_0 = 0, t_h = +inf)
    n_layers: int  # h  (bridge layers are 1..h)
    edge_layer: np.ndarray  # [m] int32: 0 intra-DC else 1..h
    comp_of_dc: np.ndarray  # [h+1, D] component label of each DC per layer
    layers: List[List[BridgeSubgraph]]  # layers[i] -> BSs at layer i (i>=1)
    mean_layer_latency: np.ndarray  # [h+1] mean RTT of edges in each layer
    _bs_by_id: Dict[int, BridgeSubgraph] = dataclasses.field(default_factory=dict)

    # ---------------------------------------------------------------- lookup
    def bs(self, bs_id: int) -> BridgeSubgraph:
        return self._bs_by_id[bs_id]

    def all_bs(self) -> List[BridgeSubgraph]:
        return [b for layer in self.layers for b in layer]

    def bs_for_dc(self, layer: int, dc: int) -> Optional[BridgeSubgraph]:
        """The BS at ``layer`` whose merged component contains ``dc``."""
        comp = self.comp_of_dc[layer, dc]
        for b in self.layers[layer]:
            if b.comp == comp:
                return b
        return None

    def cluster_dcs(self, layer: int, comp: int) -> np.ndarray:
        return np.where(self.comp_of_dc[layer] == comp)[0]

    def bs_children(self, b: BridgeSubgraph) -> List[BridgeSubgraph]:
        """Child BSs one layer below, within b's cluster (may be empty at L1)."""
        if b.layer <= 1:
            return []
        lower = []
        for child_comp in b.children:
            for cand in self.layers[b.layer - 1]:
                if cand.comp == child_comp:
                    lower.append(cand)
        return lower

    def layer_for_latency(self, latency_s: float) -> int:
        """Layer k s.t. latency in [t_{k-1}, t_k): the sink target (Alg. 1)."""
        t = [0.0] + list(self.thresholds_s)
        for k in range(len(t) - 1, 0, -1):
            if latency_s >= t[k]:
                return min(k + 1, self.n_layers)
        return 1

    def eta_L(self, layer: int) -> float:
        """Ratio of a layer's mean latency to the topmost layer's (Eq. 14)."""
        top = self.mean_layer_latency[self.n_layers]
        if top <= 0:
            return 1.0
        return float(self.mean_layer_latency[layer] / top)

    def summary(self) -> str:
        lines = [
            f"LayeredGraph: {self.env.n_dcs} DCs, {self.g.n_edges} edges, "
            f"h={self.n_layers} bridge layers, thresholds={self.thresholds_s}"
        ]
        for i in range(1, self.n_layers + 1):
            n_edges = int((self.edge_layer == i).sum())
            lines.append(
                f"  Layer_{i}: {len(self.layers[i])} bridge subgraphs, "
                f"{n_edges} edges, comps={len(np.unique(self.comp_of_dc[i]))}"
            )
        return "\n".join(lines)


def _default_thresholds(env: GeoEnvironment, interval_s: float) -> List[float]:
    """Fixed-interval bucketing (paper §VII-A uses 100 ms buckets)."""
    max_rtt = float(env.rtt_s.max())
    h = max(1, int(np.ceil(max_rtt / interval_s + 1e-9)))
    return [interval_s * k for k in range(1, h)]


def _assign_edge_layers(
    src_dc: np.ndarray,
    dst_dc: np.ndarray,
    env: GeoEnvironment,
    thresholds_s: Sequence[float],
) -> Tuple[np.ndarray, np.ndarray]:
    """Layer index per edge (0 intra-DC, else 1..h) + its RTT (Def. 1)."""
    h = len(thresholds_s) + 1
    cross = src_dc != dst_dc
    edge_rtt = env.rtt_s[src_dc, dst_dc]
    t = np.asarray([0.0] + list(thresholds_s) + [np.inf])
    # f(e)=i  <=>  delta(e) in [t_{i-1}, t_i)
    edge_layer = np.searchsorted(t, edge_rtt, side="right").astype(np.int32)
    edge_layer = np.clip(edge_layer, 1, h)
    edge_layer[~cross] = 0
    return edge_layer, edge_rtt


def _mean_layer_latency(
    edge_layer: np.ndarray,
    edge_rtt: np.ndarray,
    thresholds_s: Sequence[float],
    latency_interval_s: float,
) -> np.ndarray:
    h = len(thresholds_s) + 1
    t = np.asarray([0.0] + list(thresholds_s) + [np.inf])
    mean_lat = np.zeros(h + 1)
    for i in range(1, h + 1):
        m = edge_layer == i
        mean_lat[i] = float(edge_rtt[m].mean()) if m.any() else (
            float((t[i - 1] + min(t[i], t[i - 1] + latency_interval_s)) / 2.0)
        )
    return mean_lat


def _grow_layers(
    src_dc: np.ndarray,
    dst_dc: np.ndarray,
    edge_layer: np.ndarray,
    comp_of_dc: np.ndarray,
    layers: List[List[BridgeSubgraph]],
    bs_by_id: Dict[int, BridgeSubgraph],
    start_layer: int,
    h: int,
    next_bs: int,
    n_dcs: int,
) -> int:
    """Iterative component merging for layers ``start_layer..h``.

    Fills ``comp_of_dc[i]`` / ``layers[i]`` / ``bs_by_id`` in place from the
    components already recorded at ``start_layer - 1``.  The union-find labels
    are canonical (component root = smallest member, renumbered by sorted
    root), so the result is a pure function of the *edge set* per layer —
    which is what makes incremental repair produce rebuild-identical output.
    Returns the next free bs_id.
    """
    for i in range(start_layer, h + 1):
        prev = comp_of_dc[i - 1]
        eids = np.where(edge_layer == i)[0]
        # project layer-i edges onto previous components (DC granularity)
        e_src_c = prev[src_dc[eids]]
        e_dst_c = prev[dst_dc[eids]]
        n_prev = int(prev.max()) + 1 if n_dcs else 0
        labels = weakly_connected_components(n_prev, e_src_c, e_dst_c)
        comp_of_dc[i] = labels[prev]
        # one BS per new component that actually merged something / has edges
        for new_c in np.unique(labels):
            members_prev = np.where(labels == new_c)[0]  # prev comp ids
            bs_edges = eids[(labels[e_src_c] == new_c)]
            if len(bs_edges) == 0:
                continue  # pass-through component, no bridge subgraph
            dcs = np.where(comp_of_dc[i] == new_c)[0]
            b = BridgeSubgraph(
                layer=i,
                bs_id=next_bs,
                comp=int(new_c),
                edge_ids=bs_edges,
                children=[int(c) for c in members_prev],
                dcs=dcs,
            )
            layers[i].append(b)
            bs_by_id[next_bs] = b
            next_bs += 1
    return next_bs


def build_layered_graph(
    g: Graph,
    env: GeoEnvironment,
    thresholds_s: Optional[Sequence[float]] = None,
    latency_interval_s: float = 0.100,
) -> LayeredGraph:
    """Construct the layered graph from a geo-partitioned graph.

    Edge latency (Def. 1 ``delta``) = RTT between the owning DCs; thresholds
    default to fixed ``latency_interval_s`` buckets spanning the env's RTTs.
    """
    if thresholds_s is None:
        thresholds_s = _default_thresholds(env, latency_interval_s)
    thresholds_s = list(thresholds_s)
    h = len(thresholds_s) + 1
    D = env.n_dcs

    src_dc, dst_dc = g.edge_dc_pair()
    edge_layer, edge_rtt = _assign_edge_layers(src_dc, dst_dc, env, thresholds_s)
    mean_lat = _mean_layer_latency(edge_layer, edge_rtt, thresholds_s, latency_interval_s)

    comp_of_dc = np.zeros((h + 1, D), dtype=np.int32)
    comp_of_dc[0] = np.arange(D)  # Layer_0: each DC is its own component
    layers: List[List[BridgeSubgraph]] = [[] for _ in range(h + 1)]
    bs_by_id: Dict[int, BridgeSubgraph] = {}
    _grow_layers(
        src_dc, dst_dc, edge_layer, comp_of_dc, layers, bs_by_id,
        start_layer=1, h=h, next_bs=0, n_dcs=D,
    )

    lg = LayeredGraph(
        g=g,
        env=env,
        thresholds_s=thresholds_s,
        n_layers=h,
        edge_layer=edge_layer,
        comp_of_dc=comp_of_dc,
        layers=layers,
        mean_layer_latency=mean_lat,
        _bs_by_id=bs_by_id,
    )
    return lg


# ------------------------------------------------------- incremental repair
@dataclasses.dataclass
class RepairStats:
    touched_layers: List[int]  # layers whose edge membership changed
    first_dirty: Optional[int]  # lowest layer whose DC-components changed
    relabeled_layers: int  # layers recomputed from scratch (>= first_dirty)
    patched_layers: int  # clean layers whose BS edge lists were patched
    n_new_bs: int


def _layer_pair_keys(
    edge_layer: np.ndarray,
    src_dc: np.ndarray,
    dst_dc: np.ndarray,
    n_dcs: int,
    layer: int,
) -> np.ndarray:
    """Canonical (min, max) DC-pair keys of the alive edges in ``layer``."""
    e = np.where(edge_layer == layer)[0]
    a = src_dc[e].astype(np.int64)
    b = dst_dc[e].astype(np.int64)
    return np.unique(np.minimum(a, b) * n_dcs + np.maximum(a, b))


def repair_layered_graph(
    lg: LayeredGraph,
    g2: Graph,
    edge_alive: np.ndarray,
    latency_interval_s: float = 0.100,
) -> Tuple[LayeredGraph, RepairStats]:
    """Incrementally repair ``lg`` after a mutation batch (paper §V update
    maintenance, layered-graph side).

    ``g2`` extends ``lg.g`` with appended vertices/edges (stable ids); dead
    edges are flagged ``~edge_alive`` and get ``edge_layer = -1``.  The DC
    components of layer ``i`` depend only on which *DC pairs* carry alive
    edges at each layer ``<= i``, so:

      * layers whose pair-presence set is unchanged keep their components and
        bridge subgraphs — only the BS edge-id lists are patched where edge
        membership changed;
      * from the lowest pair-dirty layer upward, components and BSs are
        recomputed with the exact build code path (``_grow_layers``), which
        yields output identical to a from-scratch rebuild.

    Vertex mutations never dirty components directly (components live at DC
    granularity); only cross-DC edge births/deaths in new pairs do.
    """
    env = lg.env
    thresholds_s = lg.thresholds_s
    h = lg.n_layers
    D = env.n_dcs
    m_old = lg.edge_layer.shape[0]
    m_new = g2.n_edges

    src_dc, dst_dc = g2.edge_dc_pair()

    # --- extend the layer assignment to new edges, tombstone dead ones ----
    old_alive = lg.edge_layer >= 0
    new_layer_tail, _ = _assign_edge_layers(
        src_dc[m_old:], dst_dc[m_old:], env, thresholds_s
    )
    edge_layer = np.concatenate([lg.edge_layer, new_layer_tail])
    newly_dead = np.zeros(m_new, dtype=bool)
    newly_dead[:m_old] = old_alive & ~edge_alive[:m_old]
    newly_dead[m_old:] = ~edge_alive[m_old:]
    born = np.zeros(m_new, dtype=bool)
    born[m_old:] = edge_alive[m_old:]

    touched = np.unique(
        np.concatenate([edge_layer[newly_dead], edge_layer[born]])
    ).astype(int)
    touched = [int(i) for i in touched if i >= 1]  # layer 0 has no BSs/comps

    # old pair sets must be read before tombstoning
    old_pairs = {
        i: _layer_pair_keys(
            np.where(old_alive, lg.edge_layer, -1),
            src_dc[:m_old], dst_dc[:m_old], D, i,
        )
        for i in touched
    }
    edge_layer[~edge_alive] = -1

    first_dirty: Optional[int] = None
    for i in sorted(touched):
        new_pairs = _layer_pair_keys(edge_layer, src_dc, dst_dc, D, i)
        if not np.array_equal(old_pairs[i], new_pairs):
            first_dirty = i
            break

    # --- rebuild structures: copy clean layers, regrow dirty ones ---------
    comp_of_dc = lg.comp_of_dc.copy()
    layers: List[List[BridgeSubgraph]] = [[] for _ in range(h + 1)]
    bs_by_id: Dict[int, BridgeSubgraph] = {}
    clean_top = h if first_dirty is None else first_dirty - 1
    patched = 0
    for i in range(1, clean_top + 1):
        patch = i in touched
        if patch:
            eids = np.where(edge_layer == i)[0]
            e_comp = comp_of_dc[i][src_dc[eids]]
            patched += 1
        for b in lg.layers[i]:
            if patch:
                b = dataclasses.replace(b, edge_ids=eids[e_comp == b.comp])
            layers[i].append(b)
            bs_by_id[b.bs_id] = b

    n_new_bs = 0
    if first_dirty is not None:
        next_bs = max(lg._bs_by_id.keys(), default=-1) + 1
        end_bs = _grow_layers(
            src_dc, dst_dc, edge_layer, comp_of_dc, layers, bs_by_id,
            start_layer=first_dirty, h=h, next_bs=next_bs, n_dcs=D,
        )
        n_new_bs = end_bs - next_bs

    edge_rtt = env.rtt_s[src_dc, dst_dc]
    mean_lat = _mean_layer_latency(edge_layer, edge_rtt, thresholds_s, latency_interval_s)

    lg2 = LayeredGraph(
        g=g2,
        env=env,
        thresholds_s=list(thresholds_s),
        n_layers=h,
        edge_layer=edge_layer,
        comp_of_dc=comp_of_dc,
        layers=layers,
        mean_layer_latency=mean_lat,
        _bs_by_id=bs_by_id,
    )
    stats = RepairStats(
        touched_layers=sorted(touched),
        first_dirty=first_dirty,
        relabeled_layers=0 if first_dirty is None else h - first_dirty + 1,
        patched_layers=patched,
        n_new_bs=n_new_bs,
    )
    return lg2, stats
