"""Incremental nearest/second-nearest replica route index (paper §VI serving).

``PlacementState.route_nearest`` re-derives the Eq. 1 routing table with a
masked argmin over the full ``[I, D, D]`` latency tensor.  That is the right
tool at build time, but the streaming store changes only a handful of replica
rows per mutation batch or migration flush — rebuilding the whole table per
event made routing the last rebuild-bound subsystem.

:class:`RouteIndex` keeps, per (item, origin DC):

  * ``nearest[x, y]``  — the latency-minimal replica DC (== the Eq. 1 route)
  * ``second[x, y]``   — the runner-up replica DC (-1 when < 2 replicas)

and patches *only affected rows* on replica-set deltas:

  * ``add_replicas``  — O(K·D) compare-and-shift against the cached pair;
    no argmin, no [K, D, D] temporary.
  * ``drop_replicas`` — rows whose nearest was dropped promote their cached
    second in O(1), then only the vacated ``second`` slots are re-derived.
  * ``apply_moves``   — a migration move-set, grouped per (DC, kind).
  * ``apply_batch``   — a mutation batch: grows the id space (vertex block
    inserts shift the edge block), clears tombstoned rows, seeds new ones.

The index *owns* its ``nearest`` array; :class:`~repro.core.store.GeoGraphStore`
aliases ``state.route`` to it so every consumer of the routing table sees
patches immediately.  ``verify`` cross-checks against a from-scratch
``route_nearest`` rebuild (the differential invariant under test in
``tests/test_route_index.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from .graph import grow_item_rows
from .latency import GeoEnvironment

__all__ = ["RouteIndex", "RouteIndexStats", "RoutePartition"]


@dataclasses.dataclass
class RouteIndexStats:
    """Cumulative patch accounting (how much rebuild work the index avoided)."""

    full_rebuilds: int = 0
    rows_patched: int = 0  # rows re-derived by masked argmin
    rows_promoted: int = 0  # drop fixed by promoting the cached second
    rows_shifted: int = 0  # add fixed by compare-and-shift (no argmin)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class RouteIndex:
    """``[n_items, n_dcs]`` nearest + second-nearest replica index."""

    def __init__(self, env: GeoEnvironment, n_items: int) -> None:
        self.env = env
        lat = env.rtt_s.copy()
        np.fill_diagonal(lat, 0.0)
        self.lat = lat  # [d, y] serving-DC -> origin latency (size-free, Eq. 1)
        self.nearest = np.full((n_items, env.n_dcs), -1, dtype=np.int32)
        self.second = np.full((n_items, env.n_dcs), -1, dtype=np.int32)
        self.stats = RouteIndexStats()
        # change-event subscribers (the sharded store's per-origin partitions
        # mirror the index through these instead of polling): fn(kind, payload)
        # with kinds "rows" (patched row ids), "grow" ((old_n_nodes, n_new_v,
        # n_new_e)), "take" (row permutation), "rebuild" (None)
        self._listeners: List[Callable[[str, object], None]] = []

    # --------------------------------------------------------------- events
    def subscribe(self, fn: Callable[[str, object], None]) -> None:
        """Register a change listener; fired after each index mutation, when
        the placement ``delta`` the mutation derived from is still current."""
        self._listeners.append(fn)

    def _emit(self, kind: str, payload: object = None) -> None:
        for fn in self._listeners:
            fn(kind, payload)

    # ------------------------------------------------------------- building
    @staticmethod
    def build(delta: np.ndarray, env: GeoEnvironment) -> "RouteIndex":
        idx = RouteIndex(env, delta.shape[0])
        idx.rebuild(delta)
        return idx

    @property
    def n_items(self) -> int:
        return self.nearest.shape[0]

    def _argmin2(self, delta_rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Masked (nearest, second) argmin over serving DCs for ``delta_rows``.

        Ties break toward the lower DC id, matching ``route_nearest``."""
        big = np.where(delta_rows[:, :, None], self.lat[None, :, :], np.inf)
        nearest = np.argmin(big, axis=1).astype(np.int32)  # [K, y]
        k = np.arange(big.shape[0])[:, None]
        y = np.arange(big.shape[2])[None, :]
        best = big[k, nearest, y]
        big[k, nearest, y] = np.inf
        second = np.argmin(big, axis=1).astype(np.int32)
        second_ok = np.isfinite(big[k, second, y])
        second = np.where(second_ok, second, -1).astype(np.int32)
        none = ~np.isfinite(best)
        nearest = np.where(none, -1, nearest).astype(np.int32)
        return nearest, second

    def rebuild(self, delta: np.ndarray) -> None:
        """Full from-scratch derivation (init / strategy switch / fallback)."""
        self.nearest, self.second = self._argmin2(delta)
        self.stats.full_rebuilds += 1
        if self._listeners:
            self._emit("rebuild")

    def patch_rows(self, delta: np.ndarray, rows: np.ndarray) -> None:
        """Re-derive exactly ``rows`` (replica sets changed arbitrarily)."""
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) == 0:
            return
        self.nearest[rows], self.second[rows] = self._argmin2(delta[rows])
        self.stats.rows_patched += len(rows)
        if self._listeners:
            self._emit("rows", rows)

    # ----------------------------------------------------------- delta ops
    def add_replicas(self, delta: np.ndarray, items: np.ndarray, dc: int) -> None:
        """Absorb "replica of ``items`` appeared at ``dc``" without argmin.

        The new candidate either beats the cached nearest (shift nearest into
        second), beats only the second (replace it), or loses to both (no-op).
        Rows that already referenced ``dc`` (re-add after a rollback) fall
        back to a row patch."""
        items = np.asarray(items, dtype=np.int64)
        if len(items) == 0:
            return
        stale = (self.nearest[items] == dc).any(axis=1) | (
            self.second[items] == dc
        ).any(axis=1)
        if stale.any():
            self.patch_rows(delta, items[stale])
            items = items[~stale]
            if len(items) == 0:
                return
        n = self.nearest[items]  # [K, D]
        s = self.second[items]
        cand = self.lat[dc][None, :]  # [1, D] broadcast over rows
        n_lat = np.where(n >= 0, self.lat[np.maximum(n, 0), np.arange(n.shape[1])[None, :]], np.inf)
        s_lat = np.where(s >= 0, self.lat[np.maximum(s, 0), np.arange(s.shape[1])[None, :]], np.inf)
        # strict '<' keeps the lower-DC-id tie-break of the argmin derivation:
        # an equal-latency newcomer with a higher id must not displace the
        # incumbent; with a lower id it must (argmin would have picked it)
        beats_n = (cand < n_lat) | ((cand == n_lat) & (dc < n))
        beats_s = ~beats_n & ((cand < s_lat) | ((cand == s_lat) & (dc < s)))
        s2 = np.where(beats_n, n, np.where(beats_s, dc, s))
        n2 = np.where(beats_n, dc, n)
        self.nearest[items] = n2.astype(np.int32)
        self.second[items] = s2.astype(np.int32)
        self.stats.rows_shifted += len(items)
        if self._listeners:
            self._emit("rows", items)

    def drop_replicas(self, delta: np.ndarray, items: np.ndarray, dc: int) -> None:
        """Absorb "replica of ``items`` vanished from ``dc``".

        Rows not referencing ``dc`` are untouched.  Rows whose nearest was
        ``dc`` promote the cached second in O(1); every row that lost its
        second slot (by promotion or direct hit) re-derives only that slot
        with an argmin restricted to non-nearest replicas."""
        items = np.asarray(items, dtype=np.int64)
        if len(items) == 0:
            return
        n = self.nearest[items]
        s = self.second[items]
        hit_n = n == dc
        hit_s = s == dc
        touched = hit_n.any(axis=1) | hit_s.any(axis=1)
        items = items[touched]
        if len(items) == 0:
            return
        n, s, hit_n, hit_s = n[touched], s[touched], hit_n[touched], hit_s[touched]
        n = np.where(hit_n, s, n)  # promote second into vacated nearest
        vacated = hit_n | hit_s
        self.stats.rows_promoted += int(hit_n.any(axis=1).sum())
        # re-derive the vacated second slots: argmin over replicas != nearest
        big = np.where(delta[items][:, :, None], self.lat[None, :, :], np.inf)
        k = np.arange(len(items))[:, None]
        y = np.arange(n.shape[1])[None, :]
        big[k, np.maximum(n, 0), y] = np.inf  # exclude the (new) nearest
        s_new = np.argmin(big, axis=1).astype(np.int32)
        s_new = np.where(np.isfinite(big[k, s_new, y]), s_new, -1)
        s = np.where(vacated, s_new, s)
        # a row that lost its only replica: nearest promoted to -1 already
        self.nearest[items] = n.astype(np.int32)
        self.second[items] = s.astype(np.int32)
        if self._listeners:
            self._emit("rows", items)

    def apply_moves(self, delta: np.ndarray, moves: Sequence) -> None:
        """Patch the index for an applied migration move-set.

        ``delta`` must already reflect the moves (the caller mutates placement
        first, exactly like ``apply_plan``).  Moves are grouped per (dc, kind)
        so each group is one vectorized patch."""
        groups: Dict[Tuple[int, str], List[int]] = {}
        for m in moves:
            groups.setdefault((int(m.dc), m.kind), []).append(int(m.item))
        self.apply_grouped(
            delta,
            [(dc, kind, np.asarray(its, dtype=np.int64))
             for (dc, kind), its in sorted(groups.items())],
        )

    def apply_grouped(
        self, delta: np.ndarray, groups: Sequence[Tuple[int, str, np.ndarray]]
    ) -> None:
        """Patch pre-grouped replica-set deltas: ``(dc, kind, items)`` triples.

        The array-native entry the migration transfer pipeline uses per wave
        (a :class:`~repro.streaming.migration.TransferBatch` is already one
        ``(dst, "add", items)`` group — no per-move Python loop).  Drops go
        first: the drop path re-derives vacated slots from the final delta,
        so adds resolved afterwards see consistent cached state."""
        for dc, kind, its in sorted(groups, key=lambda t: t[1] != "drop"):
            arr = np.unique(np.asarray(its, dtype=np.int64))
            if kind == "add":
                self.add_replicas(delta, arr, int(dc))
            else:
                self.drop_replicas(delta, arr, int(dc))

    # ------------------------------------------------------ id-space deltas
    def grow(self, old_n_nodes: int, n_new_vertices: int, n_new_edges: int) -> None:
        """Insert rows for new vertices (mid) / edges (end), v|e id layout —
        through the one shared encoding, so index rows can never desync from
        the placement rows grown the same way."""
        self.nearest = grow_item_rows(
            self.nearest, old_n_nodes, n_new_vertices, n_new_edges, -1
        )
        self.second = grow_item_rows(
            self.second, old_n_nodes, n_new_vertices, n_new_edges, -1
        )
        if self._listeners:
            self._emit("grow", (old_n_nodes, n_new_vertices, n_new_edges))

    def clear_rows(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int64)
        self.nearest[rows] = -1
        self.second[rows] = -1
        if self._listeners:
            self._emit("rows", rows)

    def apply_batch(
        self,
        delta: np.ndarray,
        old_n_nodes: int,
        n_new_vertices: int,
        n_new_edges: int,
        changed_rows: np.ndarray,
        dead_rows: np.ndarray,
    ) -> None:
        """Absorb one mutation batch: grow the id space (edge block shifts by
        the new-vertex count), tombstone dead rows, derive the changed ones."""
        self.grow(old_n_nodes, n_new_vertices, n_new_edges)
        self.clear_rows(dead_rows)
        live = np.asarray(changed_rows, dtype=np.int64)
        dead_mask = np.zeros(self.n_items, dtype=bool)
        dead_mask[np.asarray(dead_rows, dtype=np.int64)] = True
        self.patch_rows(delta, live[~dead_mask[live]])

    # -------------------------------------------------------- reordering
    def take_rows(self, order: np.ndarray) -> None:
        """Re-key the index onto a compacted id space (row permutation only:
        stored values are DC ids, which compaction never renumbers)."""
        order = np.asarray(order, dtype=np.int64)
        self.nearest = self.nearest[order]
        self.second = self.second[order]
        if self._listeners:
            self._emit("take", order)

    # ------------------------------------------------------------- checking
    def verify(self, delta: np.ndarray) -> bool:
        """True iff the incremental index equals a from-scratch derivation."""
        ref_n, ref_s = self._argmin2(delta)
        return bool(
            np.array_equal(self.nearest, ref_n) and np.array_equal(self.second, ref_s)
        )


class RoutePartition:
    """One origin DC's column of the route index, owned by a store shard.

    The sharded store keeps the coordinator :class:`RouteIndex` authoritative
    and streams its change events (:meth:`RouteIndex.subscribe`) to the shard
    that owns each origin.  A partition does **not** copy the coordinator's
    column: on every event it independently re-derives its rows from the
    replicated placement map (the same masked-argmin math restricted to one
    origin), so shard/coordinator divergence is a detectable bug
    (:meth:`verify_against`) rather than definitionally impossible.

    ``delta_fn`` must return the *current* placement map — the store swaps
    the underlying array on growth and compaction, so the partition holds a
    provider, never the array itself.
    """

    def __init__(
        self,
        env: GeoEnvironment,
        dc: int,
        delta_fn: Callable[[], np.ndarray],
    ) -> None:
        self.dc = int(dc)
        lat = env.rtt_s.copy()
        np.fill_diagonal(lat, 0.0)
        self.lat_col = lat[:, self.dc]  # [D] serving-DC -> this origin
        self._delta_fn = delta_fn
        self.nearest = np.zeros(0, dtype=np.int32)
        self.second = np.zeros(0, dtype=np.int32)
        self.derive_all()

    @property
    def n_items(self) -> int:
        return self.nearest.shape[0]

    def _derive(self, delta_rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(nearest, second) for this origin over ``delta_rows`` — the
        column restriction of :meth:`RouteIndex._argmin2`, same lower-DC-id
        tie-break."""
        big = np.where(delta_rows, self.lat_col[None, :], np.inf)
        nearest = np.argmin(big, axis=1).astype(np.int32)
        k = np.arange(big.shape[0])
        best = big[k, nearest]
        big[k, nearest] = np.inf
        second = np.argmin(big, axis=1).astype(np.int32)
        second = np.where(np.isfinite(big[k, second]), second, -1).astype(np.int32)
        nearest = np.where(np.isfinite(best), nearest, -1).astype(np.int32)
        return nearest, second

    def derive_all(self) -> None:
        self.nearest, self.second = self._derive(self._delta_fn())

    def on_event(self, kind: str, payload: object) -> None:
        """Absorb one :class:`RouteIndex` change event."""
        if kind == "rows":
            rows = np.asarray(payload, dtype=np.int64)
            if len(rows) == 0:
                return
            n, s = self._derive(self._delta_fn()[rows])
            self.nearest[rows] = n
            self.second[rows] = s
        elif kind == "grow":
            old_n_nodes, n_new_vertices, n_new_edges = payload
            self.nearest = grow_item_rows(
                self.nearest, old_n_nodes, n_new_vertices, n_new_edges, -1
            )
            self.second = grow_item_rows(
                self.second, old_n_nodes, n_new_vertices, n_new_edges, -1
            )
        elif kind == "take":
            order = np.asarray(payload, dtype=np.int64)
            self.nearest = self.nearest[order]
            self.second = self.second[order]
        elif kind == "rebuild":
            self.derive_all()
        else:  # pragma: no cover - future event kinds must not silently drop
            raise ValueError(f"unknown route-index event {kind!r}")

    def verify_against(self, index: RouteIndex) -> bool:
        """True iff the partition equals the coordinator's column for this
        origin (the sharded differential invariant)."""
        return bool(
            np.array_equal(self.nearest, index.nearest[:, self.dc])
            and np.array_equal(self.second, index.second[:, self.dc])
        )
