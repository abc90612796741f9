"""Runtime invariant sanitizer for :class:`~repro_torch.core.store.GeoGraphStore`.

The static checker (``tools/geolint``) keeps *code* from breaking
the store invariants; this module checks the invariants hold in the
*running* process, with low-frequency differential checks a production
deployment can afford to leave on:

  * **route-index integrity** — the incremental nearest/second index equals
    a from-scratch masked-argmin rebuild (:meth:`RouteIndex.verify`), the
    index's differential test, run against live state instead of a test
    fixture.
  * **route-table integrity** — the store's route tables keyed by item id
    follow the index and equal the live state: on every device the
    bitmask table is the bit-packed placement map and the byte table the
    item bytes in f32, the host byte table is ``g.item_size()`` (a
    stale row would route a read over replicas that moved), and every
    set's byte scale is ``fold_shift(g.item_size())`` (a stale one would
    fold bytes on the card that are not whole units).
  * **heat-view aliasing** — every ``HeatCache.heat`` row is still a
    shared-storage view of the demand plane's one ``[D, I]`` table (the demand
    plane's exactly-once deposit depends on it; a silent copy would fork the heat).
  * **placement-journal validity** — the journal digests rows through the
    store's live uid table and its memoized region rows are sorted and
    in-range (the journal's replay-identity contract after grow/compact remaps).
  * **merged-metrics coherence** — the registry snapshot merges without a
    type clash (:meth:`MetricsRegistry.merge` raises ``ValueError`` when
    one shard registered a name as a counter and another as a gauge).

Enable with ``REPRO_SANITIZE=1``: :func:`maybe_attach` is a no-op without
it, so call sites (benchmarks, the CI smoke lanes) wire it unconditionally.
Attached, the sanitizer wraps the store's mutating entry points and runs
:meth:`StoreSanitizer.check` every ``every``-th mutation.
"""
from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np

__all__ = [
    "SanitizerError",
    "StoreSanitizer",
    "attach_sanitizer",
    "maybe_attach",
    "sanitize_enabled",
]

# store entry points that mutate placement, id space or heat — each wrapped
# call counts one "op" toward the every-N check cadence
_WRAPPED_METHODS = (
    "apply_updates",
    "flush_migrations",
    "compact",
    "maintain",
    "insert_patterns",
    "insert_patterns_incremental",
    "delete_items",
    "precache",
)


def sanitize_enabled() -> bool:
    """True iff ``REPRO_SANITIZE`` is set to a truthy value."""
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() not in (
        "", "0", "false", "no",
    )


class SanitizerError(AssertionError):
    """A store invariant does not hold at runtime."""


class StoreSanitizer:
    """Differential invariant checks over one attached store."""

    def __init__(self, store, every: int = 4) -> None:
        self.store = store
        self.every = max(1, int(every))
        self.ops_seen = 0
        self.checks_run = 0

    # ------------------------------------------------------------- checks
    def _check_route_index(self, failures: List[str]) -> None:
        idx = getattr(self.store, "route_index", None)
        if idx is None:
            return
        if not idx.verify(self.store.state.delta):
            failures.append(
                "route-index divergence: incremental nearest/second index "
                "!= from-scratch rebuild of the current placement (a patch "
                "path missed a replica-set delta)"
            )

    def _check_route_tables(self, failures: List[str]) -> None:
        tables = getattr(self.store, "route_tables", None)
        idx = getattr(self.store, "route_index", None)
        if tables is None or idx is None:
            return
        if tables.index is not idx:
            failures.append(
                "route-table divergence: the route tables follow another index "
                "than the store's (a re-place did not rebind them)"
            )
            return
        from ..core.route_tables import _bit_pack, fold_shift

        sizes = self.store.g.item_size()
        if tables.host_bytes.dtype != sizes.dtype or not np.array_equal(
            tables.host_bytes, sizes
        ):
            failures.append(
                "route-table divergence: host item bytes != g.item_size() "
                "(a growth or compaction event was missed)"
            )
        shift = fold_shift(sizes)
        if tables.shift != shift:
            failures.append(
                f"route-table divergence: byte scale {tables.shift} != {shift}, the "
                "scale of g.item_size() (a byte change did not re-derive it)"
            )
        bits = _bit_pack(self.store.state.delta)
        for dev, (tb, tz, tshift) in tables.device_tables.items():
            if tshift != shift:
                failures.append(
                    f"route-table divergence: byte scale on {dev} {tshift} != {shift}"
                )
            if not np.array_equal(tb.cpu().numpy(), bits):
                failures.append(
                    f"route-table divergence: replica bitmasks on {dev} != the "
                    "bit-packed placement (a patch event was missed)"
                )
            if not np.array_equal(tz.cpu().numpy(), sizes.astype(np.float32)):
                failures.append(
                    f"route-table divergence: item bytes on {dev} != g.item_size()"
                )

    def _check_heat_aliasing(self, failures: List[str]) -> None:
        demand = getattr(self.store, "demand", None)
        caches = getattr(self.store, "caches", None)
        if demand is None or not caches:
            return
        for d, cache in caches.items():
            if cache.demand is not demand:
                failures.append(
                    f"heat aliasing: cache[{d}] holds a different demand "
                    f"layer than the store (heat deposits would fork)"
                )
                continue
            row = cache.heat
            if row.base is not demand.heat or not np.shares_memory(
                row, demand.heat
            ):
                failures.append(
                    f"heat aliasing: cache[{d}].heat is not a view of the "
                    f"demand plane's [D, I] table (copied row — eviction "
                    f"would run on stale heat)"
                )
            elif row.shape != (demand.n_items,):
                failures.append(
                    f"heat aliasing: cache[{d}].heat shape {row.shape} != "
                    f"({demand.n_items},)"
                )

    def _check_journal(self, failures: List[str]) -> None:
        journal = getattr(self.store, "_placement_journal", None)
        if journal is None:
            return
        uid = getattr(self.store, "_item_uid", None)
        if uid is not None:
            if journal.item_uid is not uid:
                failures.append(
                    "journal digest: journal.item_uid is not the store's "
                    "live uid table (fingerprints would go stale across "
                    "compaction)"
                )
            elif len(np.unique(uid)) != len(uid):
                failures.append("journal digest: store uid table has duplicates")
        n_items = int(self.store.g.n_items)
        for regions in journal.regions.values():
            for r in regions:
                items = np.asarray(r.items)
                if items.size == 0:
                    continue
                if items.min() < 0 or items.max() >= n_items:
                    failures.append(
                        "journal digest: memoized region rows out of range "
                        "after a remap (stale imap application)"
                    )
                    return
                if np.any(np.diff(items) < 0):
                    failures.append(
                        "journal digest: memoized region rows unsorted — "
                        "breaks the decompose invariant on replay"
                    )
                    return

    def _check_metrics_merge(self, failures: List[str]) -> None:
        from ..obs.metrics import MetricsRegistry, get_registry

        snaps = []
        reg_fn = getattr(self.store, "_reg", None)
        if callable(reg_fn):
            reg = reg_fn()
        else:
            reg = getattr(self.store, "registry", None) or get_registry()
        snaps.append(reg.snapshot())
        for shard_reg in getattr(self.store, "shard_registries", []) or []:
            snaps.append(shard_reg.snapshot())
        try:
            MetricsRegistry.merge(snaps * 2)  # self-merge exercises type checks
        except ValueError as e:
            failures.append(f"metrics merge: type clash across snapshots ({e})")

    # -------------------------------------------------------------- driver
    def check(self) -> bool:
        """Run every invariant check; raises :class:`SanitizerError` on the
        first batch of failures, returns True when all hold."""
        failures: List[str] = []
        self._check_route_index(failures)
        self._check_route_tables(failures)
        self._check_heat_aliasing(failures)
        self._check_journal(failures)
        self._check_metrics_merge(failures)
        if failures:
            raise SanitizerError(
                "store invariant violation(s):\n  - " + "\n  - ".join(failures)
            )
        self.checks_run += 1
        return True

    def maybe_check(self) -> None:
        self.ops_seen += 1
        if self.ops_seen % self.every == 0:
            self.check()


def attach_sanitizer(store, every: int = 4) -> StoreSanitizer:
    """Wrap ``store``'s mutating entry points with every-N invariant checks.

    Idempotent: re-attaching returns the existing sanitizer.  The check runs
    *after* the wrapped mutation, so a violation names the op that caused it.
    """
    existing = getattr(store, "_sanitizer", None)
    if existing is not None:
        return existing
    sanitizer = StoreSanitizer(store, every=every)
    for name in _WRAPPED_METHODS:
        fn = getattr(store, name, None)
        if fn is None:
            continue

        def wrapped(*args, __fn=fn, **kwargs):
            out = __fn(*args, **kwargs)
            sanitizer.maybe_check()
            return out

        functools.update_wrapper(wrapped, fn)
        setattr(store, name, wrapped)
    store._sanitizer = sanitizer
    return sanitizer


def maybe_attach(store, every: int = 4) -> Optional[StoreSanitizer]:
    """:func:`attach_sanitizer` iff ``REPRO_SANITIZE`` is set; else no-op."""
    if not sanitize_enabled():
        return None
    return attach_sanitizer(store, every=every)
