"""Stepwise layered routing (paper §VI), written for the reference alone.

The same semantics as the store's online router, from the paper's
description: serve the items the origin holds; then, layer by layer in
order of latency, greedily take the DC of the origin's cluster that holds
the most still-missing items (lowest DC id on a tie) until nothing more is
covered, and go up a layer.  A layer's cluster is the set of DCs joined to
the origin by graph edges whose endpoints' DCs lie within the layer's RTT
bound.  Each serving DC's latency is Eq. 1, ``RTT + bytes / bandwidth``
(0 at the origin), the bytes summed in float64 (float32 for a read
routed alone, as the store's scalar router does); a read's latency is the
slowest.

A read's answer depends only on its items, its origin and the replica
sets, so :class:`Router` routes each distinct read once per replica-set
epoch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["cross_pairs", "components_of_pairs", "layer_components", "route_one", "Router"]


def _components(n: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in zip(a.tolist(), b.tolist()):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    return np.array([find(x) for x in range(n)], dtype=np.int64)


def cross_pairs(partition: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``[P, 2]`` the distinct DC pairs ``(lo, hi)`` that some edge joins."""
    a = partition[src].astype(np.int64)
    b = partition[dst].astype(np.int64)
    cross = a != b
    return np.unique(
        np.stack([np.minimum(a[cross], b[cross]), np.maximum(a[cross], b[cross])], 1), axis=0
    )


def components_of_pairs(rtt_s: np.ndarray, pairs: np.ndarray,
                        interval_s: float = 0.100) -> np.ndarray:
    """:func:`layer_components` from the DC pairs that edges join."""
    D = rtt_s.shape[0]
    h = max(1, int(np.ceil(float(rtt_s.max()) / interval_s + 1e-9)))
    bounds = np.array([interval_s * k for k in range(h + 1)] + [np.inf])
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    pair_layer = np.clip(
        np.searchsorted(bounds, rtt_s[pairs[:, 0], pairs[:, 1]], side="right"), 1, h
    )
    comp = np.zeros((h + 1, D), np.int64)
    comp[0] = np.arange(D)
    for layer in range(1, h + 1):
        m = pair_layer <= layer
        comp[layer] = _components(D, pairs[m, 0], pairs[m, 1])
    return comp


def layer_components(
    rtt_s: np.ndarray,
    partition: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    interval_s: float = 0.100,
) -> np.ndarray:
    """``[h + 1, D]`` cluster label of each DC at each layer (layer 0: each
    DC alone).  Layer bounds are ``interval_s`` steps up to the largest RTT;
    a DC pair joins at the layer of its RTT if any edge crosses it."""
    return components_of_pairs(rtt_s, cross_pairs(partition, src, dst), interval_s)


def route_one(
    items: np.ndarray,
    origin: int,
    delta: np.ndarray,
    comp: np.ndarray,
    sizes: np.ndarray,
    rtt_s: np.ndarray,
    bw_Bps: np.ndarray,
    lone: bool = False,
    sum_dtype=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(served_by, serving DCs ascending, their Eq. 1 latencies)``.

    ``sizes`` are the items' float32 bytes.  A DC's bytes are summed in
    float64, or in float32 for a ``lone`` read: one routed alone, which
    the store's scalar router sums in float32; ``sum_dtype`` forces one
    dtype for every read."""
    rows = delta[items]  # [k, D]
    served = np.full(len(items), -1, np.int64)
    served[rows[:, origin]] = origin
    for layer in range(1, comp.shape[0]):
        if (served >= 0).all():
            break
        cluster = np.where(comp[layer] == comp[layer, origin])[0]
        cluster = cluster[cluster != origin]
        while len(cluster):
            missing = served < 0
            if not missing.any():
                break
            cover = rows[missing][:, cluster].sum(axis=0)
            j = int(np.argmax(cover))
            if cover[j] == 0:
                break
            dc = int(cluster[j])
            served[missing & rows[:, dc]] = dc
    dcs = np.unique(served[served >= 0])
    lat = np.empty(len(dcs), np.float64)
    for k, dc in enumerate(dcs.tolist()):
        if dc == origin:
            lat[k] = 0.0
        else:
            dtype = sum_dtype or (np.float32 if lone else np.float64)
            nbytes = float(np.sum(sizes[items[served == dc]], dtype=dtype))
            lat[k] = rtt_s[dc, origin] + nbytes / bw_Bps[dc, origin]
    return served, dcs, lat


class Router:
    """Routes reads over replica sets that change by epochs; memoises each
    read's answer within an epoch by a key that fixes its items, origin
    and way of summing."""

    def __init__(self, sizes, rtt_s, bw_Bps, comp, sum_dtype=None) -> None:
        self.sizes = np.asarray(sizes, np.float32)
        self.rtt_s = rtt_s
        self.bw_Bps = bw_Bps
        self.comp = comp
        self.sum_dtype = sum_dtype
        self.delta = None
        self._memo: Dict[tuple, tuple] = {}

    def set_replicas(self, delta: np.ndarray, sizes=None, comp=None) -> None:
        """A new epoch: replica sets, and where given the item bytes and
        the layers' clusters."""
        self.delta = delta
        if sizes is not None:
            self.sizes = np.asarray(sizes, np.float32)
        if comp is not None:
            self.comp = comp
        self._memo.clear()

    def route_items(self, key, items_fn, origin: int, lone: bool = False) -> tuple:
        """``(served_by, dcs, per-DC latencies, read latency)`` of the read
        of ``items_fn()``; ``key`` names it within the epoch."""
        hit = self._memo.get(key)
        if hit is None:
            served, dcs, lat = route_one(
                items_fn(), origin, self.delta, self.comp,
                self.sizes, self.rtt_s, self.bw_Bps, lone, self.sum_dtype,
            )
            hit = (served, dcs, lat, float(lat.max()) if len(lat) else 0.0)
            self._memo[key] = hit
        return hit
