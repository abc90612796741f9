"""The items each read pattern asks for, kept up with the inserts.

A pattern is a start person and its whole 1- or 2-hop knows neighbourhood
(``inputs.khop_patterns`` with ``branch`` at least every degree): the
start, its friends and the knows edges at the start, and for two hops also
the friends' friends and the knows edges at every friend.  Item ids follow
the store's layout, vertex ``v -> v`` and edge ``e -> n_nodes + e``, so a
batch that adds persons moves every edge item up by their number.

After each batch :meth:`Catalog.apply` moves every pattern to the new id
space and adds what the batch's knows edges bring into it: an edge at the
start, or on two hops at a friend of it, joins with the person at its
other end, and on two hops a new friend brings its own knows edges and
friends.  Inserts only add, so from a whole neighbourhood this is the whole
neighbourhood of the grown graph, which the reference computes afresh
(``reference/replay.py``).  Reads due from then on ask for those items.
The arrays are never changed in place: a read already handed to the store
keeps its own.
"""
from __future__ import annotations

from typing import Dict, List, Set

import numpy as np

__all__ = ["Catalog"]


class Catalog:
    def __init__(self, g, patterns) -> None:
        n, m = int(g.n_nodes), int(g.n_edges)
        self.n_nodes, self.n_edges = n, m
        self._n_base = n
        ends = np.concatenate([g.src, g.dst]).astype(np.int64)
        other = np.concatenate([g.dst, g.src]).astype(np.int64)
        eid = np.concatenate([np.arange(m, dtype=np.int64)] * 2)
        order = np.argsort(ends, kind="stable")
        self._nbr, self._eid = other[order], eid[order]
        self._indptr = np.concatenate([[0], np.cumsum(np.bincount(ends, minlength=n))])
        self._extra: Dict[int, List[tuple]] = {}  # person -> [(friend, edge)] inserted
        self.start = np.array([p.start for p in patterns], np.int64)
        self.hops = np.array([p.hops for p in patterns], np.int64)
        if len(self.hops) and not set(self.hops.tolist()) <= {1, 2}:
            raise ValueError("inserts are followed for 1- and 2-hop patterns only")
        self.items: List[np.ndarray] = [p.items for p in patterns]
        self._at_start: Dict[int, List[int]] = {}  # person -> patterns it starts
        self._at_friend: Dict[int, Set[int]] = {}  # person -> 2-hop patterns it is a friend in
        for k, (s, h) in enumerate(zip(self.start.tolist(), self.hops.tolist())):
            self._at_start.setdefault(s, []).append(k)
            if h == 2:
                for f in np.unique(self.friends(np.array([s]))[0]).tolist():
                    self._at_friend.setdefault(f, set()).add(k)

    def friends(self, persons: np.ndarray):
        """``(friends, edges)`` of every person of ``persons``, with repeats."""
        persons = np.asarray(persons, np.int64)
        base = persons[persons < self._n_base]
        lo, hi = self._indptr[base], self._indptr[base + 1]
        lens = hi - lo
        idx = np.repeat(lo - np.cumsum(lens) + lens, lens) + np.arange(int(lens.sum()))
        nb, eb = [self._nbr[idx]], [self._eid[idx]]
        for u in persons.tolist():
            for f, e in self._extra.get(u, ()):
                nb.append(np.array([f], np.int64))
                eb.append(np.array([e], np.int64))
        return np.concatenate(nb), np.concatenate(eb)

    def apply(self, batch) -> int:
        """Absorb one sealed batch; returns the patterns that grew."""
        old_n = self.n_nodes
        nv, ne = len(batch.vertex_size), len(batch.edge_src)
        self.n_nodes += nv
        if nv:
            for p, it in enumerate(self.items):
                cut = int(np.searchsorted(it, old_n))
                if cut < len(it):
                    self.items[p] = np.concatenate([it[:cut], it[cut:] + nv])
        edges = list(zip(np.asarray(batch.edge_src, np.int64).tolist(),
                         np.asarray(batch.edge_dst, np.int64).tolist(),
                         range(self.n_edges, self.n_edges + ne)))
        self.n_edges += ne
        for a, b, e in edges:
            self._extra.setdefault(a, []).append((b, e))
            self._extra.setdefault(b, []).append((a, e))
        adds: Dict[int, list] = {}
        for a, b, e in edges:
            item = self.n_nodes + e
            for u, x in ((a, b), (b, a)):
                for p in self._at_start.get(u, ()):
                    adds.setdefault(p, []).append(np.array([item, x]))
                    if self.hops[p] == 2:  # a new friend: its edges and friends join
                        nb, eb = self.friends(np.array([x]))
                        adds[p] += [nb, self.n_nodes + eb]
                        self._at_friend.setdefault(x, set()).add(p)
                for p in self._at_friend.get(u, ()):
                    adds.setdefault(p, []).append(np.array([item, x]))
        for p, parts in adds.items():
            it = self.items[p]
            new = np.unique(np.concatenate(parts))
            at = np.searchsorted(it, new)
            held = np.zeros(len(new), bool)
            inside = at < len(it)
            held[inside] = it[at[inside]] == new[inside]
            self.items[p] = np.insert(it, at[~held], new[~held])
        return len(adds)
