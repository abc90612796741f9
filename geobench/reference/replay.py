"""The run's inserts replayed for the reference, batch by batch.

Plain NumPy, from the benchmark's inputs and the batches the run logged
(never from the program's arrays).  Items are numbered as the store
numbers them: vertex ``v`` is item ``v`` and edge ``e`` is item
``n_nodes + e``, new persons after the old ones and new knows edges after
the old edges, so a batch that adds ``nv`` persons moves every edge item up
by ``nv``.  Each item has a uid that never changes: the build's items are
their own ids, and a batch's new items take the next uids, its persons
first, in id order.

The replica sets follow the store's contract for inserts, with no flush
in the window: a new person is held at its partition DC, a new knows edge
at its source person's partition DC, and no other row changes.

A read pattern is its start person's whole 1- or 2-hop knows
neighbourhood (every knows edge of each person short of the last hop, and
every person met); a batch makes each pattern whose start, or a person
within one hop less than its hops, gained an edge the whole neighbourhood
in the new graph.  Every other pattern keeps its items, moved to the new
ids.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .route import components_of_pairs, cross_pairs

__all__ = ["Replay", "graph_rows", "rows_differing_by_uid"]


class Replay:
    """Graph, replica sets, uids and patterns at epoch ``epoch`` (batches
    applied)."""

    def __init__(self, g, delta: np.ndarray, patterns, rtt_s: np.ndarray) -> None:
        self.n = int(g.n_nodes)
        self.src = np.asarray(g.src, np.int64).copy()
        self.dst = np.asarray(g.dst, np.int64).copy()
        self.node_size = np.asarray(g.node_size, np.float32).copy()
        self.edge_size = np.asarray(g.edge_size, np.float32).copy()
        self.partition = np.asarray(g.partition, np.int64).copy()
        self.delta = np.asarray(delta, bool).copy()
        self.uid = np.arange(self.n + len(self.src), dtype=np.int64)
        self.next_uid = len(self.uid)
        self.epoch = 0
        self.n_at: List[int] = [self.n]  # persons at each epoch
        self._rtt_s = rtt_s
        self.pairs = cross_pairs(self.partition, self.src, self.dst)
        # the build's knows edges, both ways, by person; inserted ones apart
        n0, m0 = self.n, len(self.src)
        ends = np.concatenate([self.src, self.dst])
        order = np.argsort(ends, kind="stable")
        self._b_other = np.concatenate([self.dst, self.src])[order]
        self._b_edge = np.concatenate([np.arange(m0)] * 2)[order]
        self._b_ptr = np.searchsorted(ends[order], np.arange(n0 + 1))
        self._n0 = n0
        self._start = [int(p.start) for p in patterns]
        self._hops = [int(p.hops) for p in patterns]
        self.history = [[(0, np.asarray(p.items, np.int64))] for p in patterns]

    # ---------------------------------------------------------- the graph
    @property
    def n_items(self) -> int:
        return self.n + len(self.src)

    def sizes(self) -> np.ndarray:
        return np.concatenate([self.node_size, self.edge_size])

    def comp(self) -> np.ndarray:
        return components_of_pairs(self._rtt_s, self.pairs)

    def _adjacent(self, persons: np.ndarray):
        """``(person, edge)`` pairs of every knows edge at ``persons``."""
        persons = np.unique(np.asarray(persons, np.int64))
        old = persons[persons < self._n0]
        parts_p, parts_e = [], []
        for u in old.tolist():
            a, b = self._b_ptr[u], self._b_ptr[u + 1]
            parts_p.append(self._b_other[a:b])
            parts_e.append(self._b_edge[a:b])
        m0 = len(self._b_edge) // 2
        s, d = self.src[m0:], self.dst[m0:]
        at_s, at_d = np.isin(s, persons), np.isin(d, persons)
        ins = np.arange(m0, len(self.src))
        parts_p += [d[at_s], s[at_d]]
        parts_e += [ins[at_s], ins[at_d]]
        return np.concatenate(parts_p), np.concatenate(parts_e)

    def neighbourhood(self, start: int, hops: int) -> np.ndarray:
        reached = np.zeros(self.n, bool)
        reached[start] = True
        frontier = np.array([start])
        edges = []
        for _ in range(hops):
            nb, eb = self._adjacent(frontier)
            edges.append(eb)
            frontier = np.unique(nb[~reached[nb]])
            reached[frontier] = True
        return np.union1d(np.flatnonzero(reached), self.n + np.unique(np.concatenate(edges)))

    def _near(self, start: int, hops: int) -> np.ndarray:
        near = np.array([start])
        for _ in range(hops):
            near = np.union1d(near, self._adjacent(near)[0])
        return near

    # -------------------------------------------------------------- apply
    def apply(self, batch) -> None:
        """One logged batch: grow every row in the id layout, place the new
        items' primaries, give them uids, and redo the touched patterns."""
        n_old, m_old = self.n, len(self.src)
        nv, ne = len(batch.vertex_size), len(batch.edge_src)
        D = self.delta.shape[1]
        n_new = n_old + nv
        grown = np.zeros((n_new + m_old + ne, D), bool)
        grown[:n_old] = self.delta[:n_old]
        grown[n_new:n_new + m_old] = self.delta[n_old:]
        uid = np.empty(n_new + m_old + ne, np.int64)
        uid[:n_old] = self.uid[:n_old]
        uid[n_new:n_new + m_old] = self.uid[n_old:]
        uid[n_old:n_new] = self.next_uid + np.arange(nv)
        uid[n_new + m_old:] = self.next_uid + nv + np.arange(ne)
        self.next_uid += nv + ne
        self.node_size = np.concatenate([self.node_size, batch.vertex_size])
        self.partition = np.concatenate([self.partition, batch.vertex_partition])
        src = np.asarray(batch.edge_src, np.int64)
        dst = np.asarray(batch.edge_dst, np.int64)
        self.src = np.concatenate([self.src, src])
        self.dst = np.concatenate([self.dst, dst])
        self.edge_size = np.concatenate([self.edge_size, batch.edge_size])
        # primaries: a new person at its partition DC, a new knows edge at
        # its source person's
        grown[np.arange(n_old, n_new), np.asarray(batch.vertex_partition, np.int64)] = True
        grown[n_new + m_old + np.arange(ne), self.partition[src]] = True
        self.delta, self.uid, self.n = grown, uid, n_new
        self.pairs = np.unique(np.concatenate([self.pairs, cross_pairs(
            self.partition, src, dst).reshape(-1, 2)]), axis=0)
        self.epoch += 1
        self.n_at.append(self.n)
        hit = np.unique(np.concatenate([src, dst]))
        for p, (s, h) in enumerate(zip(self._start, self._hops)):
            if len(hit) and np.isin(self._near(s, h - 1), hit).any():
                self.history[p].append((self.epoch, self.neighbourhood(s, h)))

    def items_at(self, pattern: int, version: int) -> np.ndarray:
        """The items a read of ``pattern`` asked for when ``version``
        batches had been applied, in the ids of the current epoch."""
        k, items = next((k, it) for k, it in reversed(self.history[pattern]) if k <= version)
        n_then = self.n_at[k]
        return np.where(items < n_then, items, items + (self.n - n_then))

    def graph_rows(self) -> np.ndarray:
        """``[items, 5]`` rows by uid: (uid, 0, partition, -1, size bits) of
        a person, (uid, 1, source uid, destination uid, size bits) of a
        knows edge, sorted by uid."""
        return graph_rows(self.n, self.src, self.dst, self.node_size, self.edge_size,
                          self.partition, self.uid)


def graph_rows(n, src, dst, node_size, edge_size, partition, uid) -> np.ndarray:
    uid = np.asarray(uid, np.int64)
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    rows = np.empty((len(uid), 5), np.int64)
    rows[:, 0] = uid
    rows[:n, 1] = 0
    rows[:n, 2] = np.asarray(partition, np.int64)
    rows[:n, 3] = -1
    rows[:n, 4] = np.asarray(node_size, np.float32).view(np.int32)
    rows[n:, 1] = 1
    rows[n:, 2] = uid[src]
    rows[n:, 3] = uid[dst]
    rows[n:, 4] = np.asarray(edge_size, np.float32).view(np.int32)
    return rows[np.argsort(uid, kind="stable")]


def rows_differing_by_uid(a: np.ndarray, b: np.ndarray) -> int:
    """Rows of ``a`` and ``b`` (each sorted by uid, column 0) that have no
    equal row of the same uid on the other side."""
    common, ia, ib = np.intersect1d(a[:, 0], b[:, 0], return_indices=True)
    differ = int((a[ia] != b[ib]).any(axis=1).sum())
    return differ + (len(a) - len(common)) + (len(b) - len(common))
