"""Each item's replica bitmask and bytes in tables keyed by item id that
follow the route index (paper §VI serving on the card).

The fused router hands the ragged kernel item ids alone, on every device,
and every routing call folds bytes from one host table, so no call gathers
``[K, D]`` replica rows or copies ``g.item_size()``.  A store keeps one
:class:`RouteTables`:

  * ``host_bytes`` — the item bytes on the host, equal to
    ``g.item_size()`` and of its dtype (a scalar route sums them in it),
    from which the router's exact epilogue folds;
  * on each device the store's shards use, an int32 replica bitmask a row
    (bit d = ``delta[i, d]``, as :func:`_bit_pack` makes it) and the
    float32 item bytes.  This module owns that format and its limits: a
    store of more DCs than a bitmask holds
    (:data:`~repro_torch.kernels.route_expand.MAX_DCS`) or more layers than
    the kernel walks (:data:`~repro_torch.kernels.route_expand.MAX_LAYERS`)
    keeps no device tables, and its router routes on numpy;
  * ``shift``, the byte format's limit on an exact fold: a power-of-two
    scale at which every item's bytes is a whole number of units
    (``bytes * 2**shift``, below :data:`UNITS_LIMIT`), so the kernel folds
    each read's bytes per DC as int64 units, a sum equal to the host's f64
    fold bit for bit (:func:`fold_shift`); ``None`` where no scale fits.

The tables follow the store's :class:`~repro_torch.core.route_index.RouteIndex`
through its change events, as the sharded store's route partitions do:
``"rows"`` re-derives those rows' bitmasks, ``"grow"`` inserts the new
rows, ``"take"`` permutes the rows, ``"rebuild"`` derives everything
afresh.  Each event fires once the placement ``delta`` it derived from is
current, so after any placement or graph mutation the tables are never
older than ``delta``.  Tables bound to another index than the one a store
holds now are not handed to the router (:meth:`RouteTables.handed`).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.route_expand import MAX_DCS, MAX_LAYERS
from ..obs import Tracer
from .route_index import RouteIndex

__all__ = ["DeviceTables", "FOLD_MAX_ITEMS", "RouteTables", "UNITS_LIMIT", "fold_shift"]

# an item's bytes in units stay below this, and a read the card folds holds
# at most FOLD_MAX_ITEMS items, so a read's int64 sum stays below 2**63
UNITS_LIMIT = 1 << 40
FOLD_MAX_ITEMS = 1 << 23


class DeviceTables(NamedTuple):
    """One device's tables: ``bits`` [I] i32 bitmask, ``sizes`` [I] f32
    bytes and the bytes' ``shift`` (``None``: no exact fold; a caller's
    ``(bits, sizes)`` pair has none)."""
    bits: torch.Tensor
    sizes: torch.Tensor
    shift: Optional[int] = None


def fold_shift(sizes: np.ndarray) -> Optional[int]:
    """The least ``s`` at which every item's bytes times ``2**s`` is a whole
    number below :data:`UNITS_LIMIT`, or ``None`` where there is none: a
    size that is not its own float32 image (the device table's entry), is
    negative, not finite or subnormal, or sizes too far apart for the limit.

    Where it is an int, an f64 sum of any of these sizes, in any order,
    never rounds while it stays below ``2**(53 - s)``: every partial sum is
    a whole number of ``2**-s`` below ``2**53`` of them.  So the kernel's
    int64 sum of units, times ``2**-s``, is the numpy fold's value."""
    f = np.asarray(sizes).astype(np.float32)
    if not np.array_equal(f, sizes):
        return None
    if not (np.isfinite(f).all() and (f >= 0).all()):
        return None
    f = f[f > 0]
    if len(f) == 0:
        return 0
    if f.min() < np.finfo(np.float32).tiny:
        return None  # subnormal
    # each size's lowest set significand bit, as a value: the size less
    # itself with that bit cleared (exact), or the size where only the
    # leading bit is set; the least of them is 2**-s
    u = f.view(np.uint32)
    low = np.where(u & 0x7FFFFF, f - (u & (u - 1)).view(np.float32), f)
    s = 1 - int(np.frexp(low.min())[1])
    return s if float(f.max()) * 2.0 ** s < UNITS_LIMIT else None


def _bit_pack(delta: np.ndarray) -> np.ndarray:
    """``[K]`` int32 replica bitmask per row of ``delta`` (bit d = DC d),
    one OR a DC column: no float copy of the rows, which at 300k rows took
    ten times as long."""
    bits = delta[:, 0].astype(np.int32)
    for d in range(1, delta.shape[1]):
        bits |= delta[:, d].astype(np.int32) << d
    return bits


def _device_key(device) -> torch.device:
    """``device`` with its index: ``"cuda"`` names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class RouteTables:
    """Item-keyed route tables of one store: ``host_bytes``, its ``shift``
    and, per device, ``device_tables[device] = DeviceTables(bits, bytes,
    shift)``.

    ``delta_fn`` and ``sizes_fn`` return the store's *current* placement
    map and item bytes (the store swaps both arrays on growth and
    compaction, so the tables hold providers, never the arrays), and
    ``n_layers_fn`` its layered graph's bridge layers.  ``tracer`` counts
    ``route.table_rows``, the rows each event re-derives or moves, tagged
    ``event`` (the event's kind).  A set follows each device it is asked to
    keep, unless the store exceeds the kernel's limits (:meth:`fits`).
    ``shift`` is re-derived on every event that changes the bytes."""

    def __init__(
        self,
        delta_fn: Callable[[], np.ndarray],
        sizes_fn: Callable[[], np.ndarray],
        n_layers_fn: Callable[[], int],
        devices: Iterable = (),
        tracer: Optional[Tracer] = None,
    ) -> None:
        self._delta_fn = delta_fn
        self._sizes_fn = sizes_fn
        self._n_layers_fn = n_layers_fn
        self._tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.index: Optional[RouteIndex] = None
        self.host_bytes = np.zeros(0, dtype=np.float32)
        self.shift: Optional[int] = 0
        self._devices: List[torch.device] = []
        self.device_tables: Dict[torch.device, DeviceTables] = {}
        for device in devices:
            self.add_device(device)

    def fits(self) -> bool:
        """Whether the store's replica sets fit an int32 bitmask and its
        layers the kernel's walk; else no device tables are kept."""
        return self._delta_fn().shape[1] <= MAX_DCS and self._n_layers_fn() <= MAX_LAYERS

    # ------------------------------------------------------------ binding
    def add_device(self, device) -> None:
        """Keep a set of tables on ``device`` too (built at once when bound)."""
        key = _device_key(device)
        if key in self._devices:
            return
        self._devices.append(key)
        if self.index is not None and self.fits():
            self.device_tables[key] = self._upload(key, _bit_pack(self._delta_fn()))

    def bind(self, index: RouteIndex) -> None:
        """Follow ``index``'s events from now on, and derive every table
        afresh; a no-op for the index already bound."""
        if index is self.index:
            return
        self.index = index
        index.subscribe(functools.partial(self._on_event, index))
        self._rebuild()

    def handed(self, index: Optional[RouteIndex], device) -> Tuple[
            Optional[np.ndarray], Optional[DeviceTables]]:
        """What a store hands ``route_online_batch`` when it routes on
        ``device`` with ``index``: ``(host_bytes, device tables)`` while
        the tables follow ``index`` (the device tables ``None`` where none
        are kept); ``(None, None)`` for any other index."""
        if index is None or index is not self.index:
            return None, None
        return self.host_bytes, self.device_tables.get(_device_key(device))

    # -------------------------------------------------------------- events
    def _on_event(self, index: RouteIndex, kind: str, payload: object) -> None:
        if index is not self.index:
            return  # an index the store has since replaced
        if kind == "rows":
            rows = np.asarray(payload, dtype=np.int64)
            if len(rows) == 0:
                return
            bits = _bit_pack(self._delta_fn()[rows])
            for dev, t in self.device_tables.items():
                t.bits[torch.as_tensor(rows, device=dev)] = torch.as_tensor(bits, device=dev)
            n = len(rows)
        elif kind == "grow":
            n = self._grow(*payload)
        elif kind == "take":
            order = np.asarray(payload, dtype=np.int64)
            self._set_bytes(self.host_bytes[order])
            for dev, (tb, tz, _) in self.device_tables.items():
                o = torch.as_tensor(order, device=dev)
                self.device_tables[dev] = DeviceTables(tb[o], tz[o], self.shift)
            n = len(order)
        elif kind == "rebuild":
            n = self._rebuild()
        else:  # pragma: no cover - future event kinds must not silently drop
            raise ValueError(f"unknown route-index event {kind!r}")
        self._tracer.count("route.table_rows", n, event=kind)

    def _grow(self, old_n_nodes: int, n_new_vertices: int, n_new_edges: int) -> int:
        """Insert the new rows in the v|e id layout (``grow_item_rows``):
        new vertices after the old ones, the old edges shifted past them,
        new edges at the end; their entries come from the grown ``delta``
        and item bytes."""
        delta = self._delta_fn()
        n = delta.shape[0]
        sizes = self._sizes_fn()
        if len(sizes) != n:
            raise RuntimeError(f"{len(sizes)} item bytes for {n} placement rows on growth")
        self._set_bytes(sizes)
        a, nv, ne = old_n_nodes, n_new_vertices, n_new_edges
        new_rows = np.concatenate([np.arange(a, a + nv), np.arange(n - ne, n)])
        bits = _bit_pack(delta[new_rows])
        z = sizes[new_rows].astype(np.float32)
        for dev, (tb, tz, _) in self.device_tables.items():
            grown = []
            for old, fresh in ((tb, bits), (tz, z)):
                t = torch.empty(n, dtype=old.dtype, device=dev)
                t[:a] = old[:a]
                t[a + nv:n - ne] = old[a:]
                t[torch.as_tensor(new_rows, device=dev)] = torch.as_tensor(fresh, device=dev)
                grown.append(t)
            self.device_tables[dev] = DeviceTables(grown[0], grown[1], self.shift)
        return len(new_rows)

    def _set_bytes(self, sizes: np.ndarray) -> None:
        self.host_bytes = sizes
        self.shift = fold_shift(sizes)

    def _rebuild(self) -> int:
        self._set_bytes(self._sizes_fn())
        delta = self._delta_fn()
        if self.fits():
            bits = _bit_pack(delta)
            self.device_tables = {dev: self._upload(dev, bits) for dev in self._devices}
        return delta.shape[0]

    def _upload(self, dev: torch.device, bits: np.ndarray) -> DeviceTables:
        return DeviceTables(torch.tensor(bits, device=dev),
                            torch.tensor(self.host_bytes.astype(np.float32), device=dev),
                            self.shift)
