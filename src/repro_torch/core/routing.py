"""Stepwise layered routing (paper §VI).

Online mode — bottom-up expanding retrieval: serve locally, then per layer
(ascending latency) greedily pick the cluster DC covering the most missing
items (minimizing participating DCs), escalating until the pattern is fully
resolved.

Offline mode — top-down localization (map required items to candidate
replica holders) then bottom-up assembly: each DC is tested with the
migration condition (Eq. 14); excluded DCs' data is redistributed by hashing
to retained DCs within the same cluster, escalating upward when a cluster
retains nobody.  The result is an execution layout for geo-distributed
analytics (few sites, minimal WAN).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs import get_registry
from .cost import PlacementState
from .graph import Graph
from .latency import GeoEnvironment
from .layered_graph import LayeredGraph

__all__ = [
    "RouteResult",
    "RouteFastConfig",
    "get_route_fast_config",
    "set_route_fast_config",
    "route_online",
    "route_online_batch",
    "pack_request_tiles",
    "OfflineLayout",
    "route_offline",
]

# precomputed per-layer tag keys: the 5% telemetry budget on the batch
# serving path leaves no room for per-call tag normalization
_LAYER_TAGS: Dict[int, Tuple[Tuple[str, str], ...]] = {}


def _layer_tags(layer: int) -> Tuple[Tuple[str, str], ...]:
    key = _LAYER_TAGS.get(layer)
    if key is None:
        key = (("layer", str(layer)),)
        _LAYER_TAGS[layer] = key
    return key


class _ObsHandles:
    """Pre-resolved serving/routing instruments for one registry.

    The batch serve path books ~a dozen instruments per call; resolving
    each through the registry's keyed lookup costs more than the increment
    itself.  Handles are memoized in the registry's ``_handle_cache`` (so
    ``clear()`` drops them with the instruments; ``reset()`` keeps the
    instrument objects, so handles survive it)."""

    __slots__ = (
        "requests", "wan", "lat", "grid", "kernel_time", "unresolved",
        "layer_hits", "layer_time", "_reg",
    )

    def __init__(self, reg):
        self._reg = reg
        self.requests = reg.counter_keyed("serving.requests", ())
        self.wan = reg.counter_keyed("serving.wan_bytes", ())
        self.lat = reg.histogram(
            "serving.request_latency_s", quantiles=(0.5, 0.99)
        )
        self.grid = reg.counter_grid("serving.wan_bytes_link", ("src", "dst"))
        self.kernel_time = reg.counter_keyed("routing.kernel_time_s", ())
        self.unresolved = reg.counter_keyed("routing.unresolved_items", ())
        self.layer_hits: dict = {}
        self.layer_time: dict = {}

    def hits(self, layer: int):
        c = self.layer_hits.get(layer)
        if c is None:
            c = self._reg.counter_keyed("routing.layer_hits", _layer_tags(layer))
            self.layer_hits[layer] = c
        return c

    def layer_s(self, layer: int):
        c = self.layer_time.get(layer)
        if c is None:
            c = self._reg.counter_keyed(
                "routing.layer_time_s", _layer_tags(layer)
            )
            self.layer_time[layer] = c
        return c


def _obs_handles(reg) -> _ObsHandles:
    h = reg._handle_cache.get("routing")
    if h is None:
        h = _ObsHandles(reg)
        reg._handle_cache["routing"] = h
    return h


# --------------------------------------------------------- fast-path config
@dataclasses.dataclass
class RouteFastConfig:
    """Eligibility gates for the fused batch expansion on the device.

    The fast path pays fixed per-call costs (host->device transfer of the
    packed batch, kernel launch, readback), so small batches stay on the
    numpy path;
    the size gates also bound the padded ``[R, Kmax]`` buffers the packing
    allocates.  ``max_dcs`` is the int32 replica-bitmask budget (bit 31 is
    the sign bit)."""

    enabled: bool = True
    min_requests: int = 64  # below this the numpy lockstep loop wins
    max_kmax: int = 8192  # widest request (items) eligible for packing
    max_cells: int = 1 << 23  # padded R * Kmax budget (~32 MB of int32)
    max_dcs: int = 31


_FAST_CONFIG = RouteFastConfig()


def get_route_fast_config() -> RouteFastConfig:
    return _FAST_CONFIG


def set_route_fast_config(config: RouteFastConfig) -> RouteFastConfig:
    global _FAST_CONFIG
    _FAST_CONFIG = config
    return config


# ------------------------------------------------------------------- online
class RouteResult:
    """Routing outcome for one request.

    A ``__slots__`` class rather than a dataclass: the batch path
    materializes one of these per request per serve call, and
    ``per_dc_latency`` — only read by diagnostics and tests — builds its
    dict lazily from the packed ``(dcs, pair_latency)`` columns.
    """

    __slots__ = (
        "served_by",
        "dcs",
        "latency_s",
        "layers_used",
        "n_missing",
        "wan_bytes",
        "_per_dc",
        "_pair_lat",
    )

    def __init__(
        self,
        served_by: np.ndarray,  # [len(items)] serving DC per item (-1 open)
        dcs: np.ndarray,  # distinct participating DCs
        latency_s: float,  # straggler latency (max over DCs, Eq. 1)
        per_dc_latency: Optional[Dict[int, float]] = None,
        layers_used: int = 0,
        n_missing: int = 0,
        wan_bytes: float = 0.0,  # bytes served by non-origin DCs (WAN)
        pair_latency: Optional[List[float]] = None,  # aligned with dcs
    ) -> None:
        self.served_by = served_by
        self.dcs = dcs
        self.latency_s = latency_s
        self.layers_used = layers_used
        self.n_missing = n_missing
        self.wan_bytes = wan_bytes
        self._per_dc = per_dc_latency
        self._pair_lat = pair_latency

    @property
    def per_dc_latency(self) -> Dict[int, float]:
        if self._per_dc is None:
            lats = self._pair_lat if self._pair_lat is not None else ()
            self._per_dc = dict(zip([int(d) for d in self.dcs], lats))
        return self._per_dc

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"RouteResult(dcs={list(map(int, self.dcs))}, "
            f"latency_s={self.latency_s:.6g}, layers_used={self.layers_used}, "
            f"n_missing={self.n_missing}, wan_bytes={self.wan_bytes:.6g})"
        )


def route_online(
    lg: LayeredGraph,
    state: PlacementState,
    items: np.ndarray,
    origin: int,
    sizes: Optional[np.ndarray] = None,
) -> RouteResult:
    """Bottom-up expanding retrieval for one pattern request (paper Fig. 5)."""
    env = lg.env
    if sizes is None:
        sizes = lg.g.item_size()
    items = np.asarray(items)
    served = np.full(len(items), -1, dtype=np.int64)

    # Layer_0: local items first
    local = state.delta[items, origin]
    served[local] = origin
    layers_used = 0

    for layer in range(1, lg.n_layers + 1):
        if (served >= 0).all():
            break
        comp = lg.comp_of_dc[layer, origin]
        cluster = np.where(lg.comp_of_dc[layer] == comp)[0]
        cluster = cluster[cluster != origin]
        if len(cluster) == 0:
            continue
        layers_used = layer
        # greedy max-coverage within the latency-homogeneous cluster
        while True:
            missing = np.where(served < 0)[0]
            if len(missing) == 0:
                break
            cover = state.delta[items[missing]][:, cluster].sum(axis=0)
            best = int(cover.argmax())
            if cover[best] == 0:
                break  # escalate to the next layer
            dc = int(cluster[best])
            hit = missing[state.delta[items[missing], dc]]
            served[hit] = dc
    # resolved latency per participating DC (Eq. 1 with S_d = served bytes)
    per_dc: Dict[int, float] = {}
    wan = 0.0
    for dc in np.unique(served[served >= 0]):
        s_d = float(sizes[items[served == dc]].sum())
        per_dc[int(dc)] = env.request_latency(int(dc), origin, s_d)
        if int(dc) != origin:
            wan += s_d
    lat = max(per_dc.values()) if per_dc else 0.0
    return RouteResult(
        served_by=served,
        dcs=np.unique(served[served >= 0]),
        latency_s=lat,
        per_dc_latency=per_dc,
        layers_used=layers_used,
        n_missing=int((served < 0).sum()),
        wan_bytes=wan,
    )


def _expand_single_origin(
    lg: LayeredGraph,
    delta_all: np.ndarray,
    req_id: np.ndarray,
    R: int,
    o: int,
    served: np.ndarray,
    layers_used: np.ndarray,
    reg,
    obs: bool,
) -> None:
    """Greedy layered expansion for a batch that shares one origin DC.

    Request-identical to the mixed-origin lockstep loop (same greedy
    max-coverage, same lowest-DC-id tie-break), but the shared origin means
    every request sees the *same* cluster per layer — so layer-0 is a column
    slice instead of a per-row gather, coverage bincounts run over only the
    cluster's columns, and every greedy pass touches only the still-missing
    rows.  This is the per-shard serving path: the sharded store dispatches
    per-origin sub-batches, which land here.
    """
    K = delta_all.shape[0]
    local = delta_all[:, o]
    served[local] = o
    idx = np.where(~local)[0]  # flat positions still missing
    if obs:
        unresolved = len(idx)
        _obs_handles(reg).hits(0).inc(K - unresolved)
    for layer in range(1, lg.n_layers + 1):
        if len(idx) == 0:
            break
        if obs:
            t_layer = time.perf_counter()
        comp = lg.comp_of_dc[layer]
        cluster = np.where(comp == comp[o])[0]
        cluster = cluster[cluster != o]
        if len(cluster):
            layers_used[np.unique(req_id[idx])] = layer
            ar_R = np.arange(R)
            while len(idx):
                rid = req_id[idx]
                sub = delta_all[np.ix_(idx, cluster)]  # [missing, |cluster|]
                cover = np.stack(
                    [
                        np.bincount(rid, weights=sub[:, j], minlength=R)
                        for j in range(len(cluster))
                    ],
                    axis=1,
                )
                best_j = np.argmax(cover, axis=1)  # lowest-id tie-break
                gain = cover[ar_R, best_j]
                if not (gain > 0).any():
                    break  # escalate to the next layer
                hit = (gain[rid] > 0) & sub[np.arange(len(idx)), best_j[rid]]
                served[idx[hit]] = cluster[best_j[rid[hit]]]
                idx = idx[~hit]
        if obs:
            h = _obs_handles(reg)
            h.layer_s(layer).inc(time.perf_counter() - t_layer)
            h.hits(layer).inc(unresolved - len(idx))
            unresolved = len(idx)
    if obs:
        _obs_handles(reg).unresolved.inc(len(idx))


def _observe_scalar(
    reg,
    lg: LayeredGraph,
    res: RouteResult,
    items: np.ndarray,
    origin: int,
    sizes: np.ndarray,
    elapsed_s: float,
) -> None:
    """Book the batch path's serving/routing instruments for one scalar
    :func:`route_online` result, so size-1 batches can take the (faster)
    scalar router without losing accounting parity.

    The serving layer of each assignment is recovered instead of re-walking
    the expansion: greedy passes only break when *no* cluster DC covers any
    missing item, so an item is always served at the first layer whose
    cluster holds a replica — i.e. the first layer where its assigned DC
    shares a component with the origin.  Expansion time is charged to the
    deepest layer used (the scalar router doesn't time layers separately).
    """
    h = _obs_handles(reg)
    h.requests.inc(1)
    served = res.served_by
    hits0 = int((served == origin).sum())
    if hits0:
        h.hits(0).inc(hits0)
    wan_link = None
    for dc in res.dcs.tolist():
        dc = int(dc)
        if dc == origin:
            continue
        shared = lg.comp_of_dc[1:, dc] == lg.comp_of_dc[1:, origin]
        layer = int(np.argmax(shared)) + 1
        h.hits(layer).inc(int((served == dc).sum()))
        if wan_link is None:
            wan_link = np.zeros((lg.env.n_dcs, lg.env.n_dcs))
        wan_link[dc, origin] += float(sizes[items[served == dc]].sum())
    if res.layers_used > 0:
        h.layer_s(res.layers_used).inc(elapsed_s)
    h.unresolved.inc(res.n_missing)
    h.lat.observe(res.latency_s)
    h.wan.inc(res.wan_bytes)
    if wan_link is not None:
        h.grid.add(wan_link)


def _get_kops():
    """The kernels package, imported on the first fast-path call so the
    numpy router imports fast."""
    from ..kernels import autotune, ops

    return ops, autotune


def _fast_eligible(
    fast: Optional[bool], config: RouteFastConfig, R: int, D: int, kmax: int,
    n_layers: int,
) -> bool:
    if fast is False or not config.enabled or kmax == 0:
        return False
    if D > config.max_dcs or n_layers > 64:
        return False  # int32 bitmask / stats-lane budget
    if fast is not True:  # default: size heuristics decide
        if R < config.min_requests:
            return False
        if kmax > config.max_kmax or R * kmax > config.max_cells:
            return False
    return True


# per-(LayeredGraph, device) copies of the expansion constants (layer
# components, RTT, 1/bandwidth) as device tensors: a host->device copy per
# batch would cost a transfer and a sync for arrays that never change.
# Keyed on id(lg) with the lg kept referenced, so a live entry's key cannot
# be recycled; one entry suffices (one store per process).
_FAST_ENV_CACHE: Dict[tuple, Tuple[LayeredGraph, tuple]] = {}


def reset_routing_caches() -> None:
    """Reset every module-level routing cache/singleton: the per-layer tag
    intern table, the fast-path config and the per-graph device-tensor
    cache.  Test isolation hook — everything here rebuilds lazily on next
    use."""
    global _FAST_CONFIG
    _LAYER_TAGS.clear()
    _FAST_ENV_CACHE.clear()
    _FAST_CONFIG = RouteFastConfig()


def _fast_env_arrays(lg: LayeredGraph, device: torch.device) -> tuple:
    key = (id(lg), str(device))
    hit = _FAST_ENV_CACHE.get(key)
    if hit is not None:
        return hit[1]
    arrs = (
        torch.as_tensor(lg.comp_of_dc, dtype=torch.int32, device=device),
        torch.as_tensor(lg.env.rtt_s, dtype=torch.float32, device=device),
        torch.as_tensor(
            1.0 / lg.env.bw_Bps_safe(), dtype=torch.float32, device=device
        ),
    )
    _FAST_ENV_CACHE.clear()
    _FAST_ENV_CACHE[key] = (lg, arrs)
    return arrs


def _bit_pack(delta_all: np.ndarray) -> np.ndarray:
    """``[K]`` int32 replica bitmask per row of ``delta_all`` (bit d = DC d)."""
    D = delta_all.shape[1]
    if D <= 23:
        # BLAS bit-pack: bool @ f32 powers of two; every bitmask value is an
        # exact f32 integer below 2^24
        return (delta_all @ (1 << np.arange(D)).astype(np.float32)).astype(np.int32)
    return (
        delta_all.astype(np.int64) @ (1 << np.arange(D, dtype=np.int64))
    ).astype(np.int32)


def _pack_tiles(
    bits_flat, sizes_all, req_id, bounds, lens, origin, r_pad: int, k_pad: int
) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
    """The flat item stream as padded ``[r_pad, k_pad]`` request tiles:
    ``((bits, sizes, lens, origin), slot of each flat item)``.  Pad rows
    have zero items; pad slots have zero bits and bytes."""
    R = len(lens)
    pos = np.arange(len(bits_flat), dtype=np.int64) - bounds[req_id]
    bits = np.zeros((r_pad, k_pad), np.int32)
    bits[req_id, pos] = bits_flat
    szp = np.zeros((r_pad, k_pad), np.float32)
    szp[req_id, pos] = sizes_all
    lens_p = np.zeros(r_pad, np.int32)
    lens_p[:R] = lens
    origin_p = np.zeros(r_pad, np.int32)
    origin_p[:R] = origin
    return (bits, szp, lens_p, origin_p), pos


def pack_request_tiles(
    lg: LayeredGraph,
    state: PlacementState,
    requests: Sequence[Tuple[np.ndarray, int]],
) -> Tuple[np.ndarray, ...]:
    """The tile inputs the fast path hands ``route_expand`` for a batch:
    ``(bits, sizes, lens, origin, comp, rtt, ibw)`` as numpy, padded to the
    same power-of-two buckets (for checking and timing the kernel on a
    store's own batches)."""
    from ..kernels.autotune import shape_bucket

    sizes = lg.g.item_size()
    lens = np.asarray([len(it) for it, _ in requests], dtype=np.int64)
    origin = np.asarray([o for _, o in requests], dtype=np.int64)
    items_all = np.concatenate([np.asarray(it, np.int64) for it, _ in requests])
    req_id = np.repeat(np.arange(len(requests), dtype=np.int64), lens)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    tiles, _ = _pack_tiles(
        _bit_pack(state.delta[items_all]), sizes[items_all], req_id, bounds,
        lens, origin, shape_bucket(len(requests), floor=8),
        shape_bucket(int(lens.max()), floor=8),
    )
    return (
        *tiles,
        np.asarray(lg.comp_of_dc, np.int32),
        np.asarray(lg.env.rtt_s, np.float32),
        np.asarray(1.0 / lg.env.bw_Bps_safe(), np.float32),
    )


def _route_batch_fast(
    lg: LayeredGraph,
    delta_all: np.ndarray,  # [K, D] replica rows for the flat item stream
    sizes_all: np.ndarray,  # [K] item bytes, flat
    req_id: np.ndarray,  # [K] request id per flat item
    bounds: np.ndarray,  # [R + 1] request offsets into the flat stream
    lens: np.ndarray,  # [R]
    origin: np.ndarray,  # [R]
    reg,
    obs: bool,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused expansion for the whole batch on the kernels fast path.

    Bit-packs the batch's replica rows (bit d = replica at DC d).  On the
    card, a ``[R, Kmax]`` int32 tile goes through the CUDA kernel
    (``kernels.ops.route_expand_batch``); an autotuner winner other than
    ``"kernel"`` raises there.  On the CPU, the autotuned winner for
    ``(r_pad, k_pad, D, L)`` picks the subset-histogram router
    (``kernels.ops.route_expand_subsets`` — default for small DC counts,
    per-pass work independent of the item count) or the tile's plain
    version.  Every impl produces the numpy router's exact greedy picks.
    Tile rows and item slots are padded to power-of-two buckets so the
    autotuner keys on a handful of shapes across the batch mix.  Returns
    ``(served [K], layers_used [R])``; all byte/latency folds are recomputed
    exactly on the host by the shared epilogue, so results are bit-identical
    to the numpy path.
    """
    ops, autotune = _get_kops()
    dev = resolve_device(device)
    R = len(lens)
    K = delta_all.shape[0]
    D = delta_all.shape[1]
    t0 = time.perf_counter() if obs else 0.0
    kmax = int(lens.max())
    k_pad = autotune.shape_bucket(kmax, floor=8)
    r_pad = autotune.shape_bucket(R, floor=8)
    bits_flat = _bit_pack(delta_all)
    cfg = autotune.get_autotuner().lookup(
        "route_expand", (r_pad, k_pad, D, lg.n_layers)
    ) or {}
    if dev.type == "cpu":
        impl = cfg.get("impl", "subsets" if D <= ops.SUBSET_MAX_DCS else "ref")
    else:
        impl = cfg.get("impl", "kernel")
        if impl != "kernel":
            raise ValueError(
                f"route_expand impl {impl!r} does not run on {dev}: the card "
                "runs the kernel only"
            )
    if impl == "subsets" and D <= ops.SUBSET_MAX_DCS:
        served, layers_used, miss_after = ops.route_expand_subsets(
            bits_flat, req_id, R, origin, lg.comp_of_dc
        )
    else:
        (bits, szp, lens_p, origin_p), pos = _pack_tiles(
            bits_flat, sizes_all, req_id, bounds, lens, origin, r_pad, k_pad
        )
        comp, rtt, ibw = _fast_env_arrays(lg, dev)
        served_p, _, layers_used, miss_after, _, _ = ops.route_expand_batch(
            bits, szp, lens_p, origin_p, comp, rtt, ibw, device=dev
        )
        served = served_p[req_id, pos].astype(np.int64)
    if obs:
        h = _obs_handles(reg)
        h.kernel_time.inc(time.perf_counter() - t0)
        # per-layer resolved counts from the kernel's missing-after-layer
        # columns (early-exited layers report 0 missing, which telescopes
        # to zero extra hits)
        miss_tot = miss_after[:R].sum(axis=0).tolist()
        h.hits(0).inc(K - int(miss_tot[0]))
        for layer in range(1, len(miss_tot)):
            hits = int(miss_tot[layer - 1]) - int(miss_tot[layer])
            if hits:
                h.hits(layer).inc(hits)
        h.unresolved.inc(int(miss_tot[-1]))
    return served, layers_used[:R].astype(np.int64)


def route_online_batch(
    lg: LayeredGraph,
    state: PlacementState,
    requests: Sequence[Tuple[np.ndarray, int]],
    sizes: Optional[np.ndarray] = None,
    registry=None,
    fast: Optional[bool] = None,
    device: DeviceLike = None,
) -> List[RouteResult]:
    """Bottom-up expanding retrieval for a whole request batch at once.

    ``requests`` is a sequence of ``(items, origin)`` pairs.  Per request the
    outcome is identical to :func:`route_online` (same greedy max-coverage,
    same lowest-DC-id tie-break), but the batch is resolved with flat array
    ops: per layer, coverage counts for *all* requests are one segment-sum
    ``[R, D]`` and the per-request greedy pick is one masked argmax — the
    per-pattern Python loops collapse into a handful of numpy passes whose
    count is bounded by the layer's cluster width, not the batch size.

    A batch whose requests all share one origin (the sharded store's
    per-shard sub-batches) takes :func:`_expand_single_origin` instead of
    the lockstep loop — same results, less work per pass.

    ``fast`` pins the fused expansion (:mod:`repro_torch.kernels`) on
    ``device`` (``None`` = the card): ``True`` forces it, ``False`` forbids
    it, ``None`` (default) lets :class:`RouteFastConfig` size gates decide.
    The fast path computes the same greedy picks on the device and re-folds
    bytes/latency on the host in f64, so its results are bit-identical to
    the numpy path.

    ``registry`` routes serving/routing telemetry into an explicit
    :class:`~repro_torch.obs.MetricsRegistry` (a shard's private registry);
    ``None`` falls back to the process default.
    """
    env = lg.env
    R = len(requests)
    if R == 0:
        return []
    reg = registry if registry is not None else get_registry()
    if R == 1:
        # size-1 fast path: the flat batch machinery (request-id bookkeeping,
        # [R, D] coverage stacks) costs ~2x the scalar router at R == 1 and
        # the scalar path is definitionally request-identical.  With
        # telemetry enabled, _observe_scalar books the batch path's exact
        # instruments from the scalar result (the sharded store's per-shard
        # registries must account every request).
        items, origin_0 = requests[0]
        items = np.asarray(items)
        if sizes is None:
            sizes = lg.g.item_size()
        t0 = time.perf_counter() if reg.enabled else 0.0
        res = route_online(lg, state, items, int(origin_0), sizes=sizes)
        if reg.enabled:
            _observe_scalar(
                reg, lg, res, items, int(origin_0), sizes,
                time.perf_counter() - t0,
            )
        return [res]
    if sizes is None:
        sizes = lg.g.item_size()
    arrs = [np.asarray(it) for it, _ in requests]
    lens = np.fromiter((a.shape[0] for a in arrs), dtype=np.int64, count=R)
    origin = np.fromiter((o for _, o in requests), dtype=np.int64, count=R)
    items_all = (
        np.concatenate(arrs).astype(np.int64, copy=False)
        if lens.sum()
        else np.zeros(0, dtype=np.int64)
    )
    req_id = np.repeat(np.arange(R, dtype=np.int64), lens)
    K = len(items_all)
    D = env.n_dcs
    bounds = np.concatenate([[0], np.cumsum(lens)])
    # one gather each of the batch's replica rows and item bytes; every
    # greedy pass and the shared epilogue reuse them
    delta_all = state.delta[items_all]  # [K, D]
    sz_all = sizes[items_all]  # [K] f64

    # coverage telemetry: per-layer resolved-item counters + expansion
    # timing, all gated so the disabled path costs one attribute load
    obs = reg.enabled
    if obs:
        _obs_handles(reg).requests.inc(R)

    kmax = int(lens.max()) if R else 0
    if _fast_eligible(fast, _FAST_CONFIG, R, D, kmax, lg.n_layers):
        served, layers_used = _route_batch_fast(
            lg, delta_all, sz_all, req_id, bounds, lens, origin, reg, obs,
            device=device,
        )
        return _materialize_results(
            env, sz_all, req_id, bounds, origin, served,
            layers_used, R, D, reg, obs,
        )

    ar_K = np.arange(K)
    ar_R = np.arange(R)
    served = np.full(K, -1, dtype=np.int64)
    layers_used = np.zeros(R, dtype=np.int64)
    org_all = origin[req_id]
    if (origin == origin[0]).all():
        _expand_single_origin(
            lg, delta_all, req_id, R, int(origin[0]), served, layers_used, reg, obs
        )
    else:
        # Layer_0: local items first
        local = delta_all[ar_K, org_all]
        served[local] = org_all[local]

        missing_per_req = np.bincount(req_id[served < 0], minlength=R)
        if obs:
            unresolved = int(missing_per_req.sum())
            _obs_handles(reg).hits(0).inc(K - unresolved)
        for layer in range(1, lg.n_layers + 1):
            active = missing_per_req > 0
            if not active.any():
                break
            if obs:
                t_layer = time.perf_counter()
            comp = lg.comp_of_dc[layer]  # [D]
            allowed = comp[origin][:, None] == comp[None, :]  # [R, D]
            allowed[ar_R, origin] = False
            # route_online marks a layer "used" whenever its cluster is
            # non-empty for a still-unresolved request, even if nothing is
            # found there
            has_cluster = allowed.any(axis=1)
            layers_used[active & has_cluster] = layer
            # greedy max-coverage, all active requests in lockstep: each pass
            # computes every request's best cluster DC and assigns its hits —
            # requests are independent, so lockstep == per-request greedy
            while True:
                miss = served < 0
                if not miss.any():
                    break
                # segment-sum coverage per request: D bincounts beat a slow
                # ufunc.at scatter (D is a handful, the batch is the long axis)
                cover = np.stack(
                    [
                        np.bincount(req_id, weights=delta_all[:, d] * miss, minlength=R)
                        for d in range(D)
                    ],
                    axis=1,
                )
                cover[~allowed] = 0.0
                best = np.argmax(cover, axis=1)  # lowest-id tie-break
                gain = cover[ar_R, best]
                progress = gain > 0
                if not progress.any():
                    break
                hit = miss & progress[req_id] & delta_all[ar_K, best[req_id]]
                served[hit] = best[req_id[hit]]
            missing_per_req = np.bincount(req_id[served < 0], minlength=R)
            if obs:
                # cumulative seconds as a counter (count comes from
                # layer_hits' batch count): a scalar histogram observe costs
                # ~10us in P² marker maths, which the 5% serving budget
                # cannot spare
                h = _obs_handles(reg)
                h.layer_s(layer).inc(time.perf_counter() - t_layer)
                now_unresolved = int(missing_per_req.sum())
                h.hits(layer).inc(unresolved - now_unresolved)
                unresolved = now_unresolved

        if obs:
            _obs_handles(reg).unresolved.inc(unresolved)

    return _materialize_results(
        env, sz_all, req_id, bounds, origin, served, layers_used,
        R, D, reg, obs,
    )


def _materialize_results(
    env: GeoEnvironment,
    sz_all: np.ndarray,  # [K] item bytes for the flat stream, f64
    req_id: np.ndarray,  # [K]
    bounds: np.ndarray,  # [R + 1] request offsets into the flat stream
    origin: np.ndarray,  # [R]
    served: np.ndarray,  # [K] serving DC per flat item (-1 unresolved)
    layers_used: np.ndarray,  # [R]
    R: int,
    D: int,
    reg,
    obs: bool,
) -> List[RouteResult]:
    """Shared exact epilogue: fold served assignments into Eq. 1 latency,
    WAN bytes and per-request :class:`RouteResult`\\ s, entirely in host
    f64.  Both the numpy expansion and the device fast path feed this from
    their (integer, identical) ``served`` picks, which is what makes the
    fast path bit-identical — f32 device byte sums never leak into results.
    """
    ar_R = np.arange(R)
    srv = served >= 0
    if srv.all():
        # fully-resolved batch (the common case): skip the three boolean-
        # indexed copies of the flat stream
        flat = req_id * D + served
        weights = sz_all
        n_miss = np.zeros(R, np.int64)
    else:
        flat = req_id[srv] * D + served[srv]  # (request, serving DC) pair
        weights = sz_all[srv]
        n_miss = np.bincount(req_id[~srv], minlength=R)
    bytes_rd = np.bincount(flat, weights=weights, minlength=R * D).reshape(R, D)
    served_mask = np.zeros(R * D, dtype=bool)
    served_mask[flat] = True
    served_mask = served_mask.reshape(R, D)
    lat_rd = env.rtt_s[:, origin].T + bytes_rd / env.bw_Bps_safe()[:, origin].T
    lat_rd[ar_R, origin] = 0.0  # local serving is free (Eq. 1)
    straggler = np.where(served_mask, lat_rd, -np.inf).max(axis=1)
    straggler[~served_mask.any(axis=1)] = 0.0
    wan_r = bytes_rd.sum(axis=1) - bytes_rd[ar_R, origin]

    if obs:
        # serving-path telemetry, batch-granular: one sketch update for the
        # whole latency vector and one [D, D] reduction for per-link WAN
        # bytes (bytes_rd grouped by origin DC) — per-request Python here
        # would blow the 5% overhead budget of BENCH_obs
        # p50/p99 only: every tracked quantile is one more P² sketch fed per
        # batch, and the p90 sketch does not earn its ~20us here
        h = _obs_handles(reg)
        h.lat.observe_many(straggler)
        wan_total = float(wan_r.sum())
        h.wan.inc(wan_total)
        if wan_total > 0.0:
            # [serving DC, origin DC] bytes as one bincount over the R*D
            # cells — no [R, D] onehot/matmul temporaries on the hot path
            cell = (np.arange(D) * D)[None, :] + origin[:, None]  # [R, D]
            link = np.bincount(
                cell.ravel(), weights=bytes_rd.ravel(), minlength=D * D
            ).reshape(D, D)
            np.fill_diagonal(link, 0.0)  # local serving is not WAN traffic
            h.grid.add(link)

    # per-request materialization: all (r, dc) pairs at once, no np.unique;
    # per_dc_latency dicts build lazily inside RouteResult on first access.
    # Scalars are pre-extracted to python (tolist) and RouteResult is built
    # positionally — at batch 1024 this loop is the epilogue's hot half.
    rr, dd = np.nonzero(served_mask)  # row-major: grouped by request
    pair_lat = lat_rd[rr, dd].tolist()
    pair_bounds = np.cumsum(np.bincount(rr, minlength=R)).tolist()
    results: List[RouteResult] = []
    append = results.append
    straggler_l = straggler.tolist()
    layers_l = layers_used.tolist()
    n_miss_l = n_miss.tolist()
    wan_l = wan_r.tolist()
    bounds_l = bounds.tolist()
    lo = 0
    for r in range(R):
        hi = pair_bounds[r]
        append(
            RouteResult(
                served[bounds_l[r] : bounds_l[r + 1]],
                dd[lo:hi],
                straggler_l[r],
                None,
                layers_l[r],
                n_miss_l[r],
                wan_l[r],
                pair_lat[lo:hi],
            )
        )
        lo = hi
    return results


# ------------------------------------------------------------------ offline
@dataclasses.dataclass
class OfflineLayout:
    sites: np.ndarray  # retained execution DCs
    item_site: np.ndarray  # [I] executing DC per required item (-1 = n/a)
    migrated: np.ndarray  # item ids moved off their primary DC
    wan_bytes: float  # assembly traffic
    excluded: np.ndarray  # DCs ruled out by Eq. 14


def _boundary_vertices(g: Graph, dc: int) -> int:
    src_dc = g.partition[g.src]
    dst_dc = g.partition[g.dst]
    cross = src_dc != dst_dc
    b = np.unique(
        np.concatenate([g.src[cross & (src_dc == dc)], g.dst[cross & (dst_dc == dc)]])
    )
    return int(len(b))


def route_offline(
    lg: LayeredGraph,
    state: PlacementState,
    required_items: np.ndarray,
    n_iters: int = 15,
    msg_bytes: float = 16.0,
    xi_frac: float = 0.2,
) -> OfflineLayout:
    """Top-down localization + bottom-up assembly (paper Fig. 6, Eq. 14)."""
    g, env = lg.g, lg.env
    D = env.n_dcs
    sizes = g.item_size()
    required_items = np.asarray(required_items)
    req_mask = np.zeros(g.n_items, dtype=bool)
    req_mask[required_items] = True

    # --- top-down localization: candidate holders per required item -------
    # (delta already encodes all replicas; localization = restricting to it.)
    primary = np.zeros(g.n_items, dtype=np.int64)
    primary[: g.n_nodes] = g.partition
    primary[g.n_nodes :] = g.partition[g.src]

    # --- Eq. 14 migration test per DC --------------------------------------
    total_boundary = sum(_boundary_vertices(g, d) for d in range(D))
    xi = xi_frac * n_iters * msg_bytes * max(total_boundary, 1)
    eta_l = lg.eta_L(1)
    retained: List[int] = []
    excluded: List[int] = []
    for d in range(D):
        local_req = required_items[primary[required_items] == d]
        if len(local_req) == 0:
            excluded.append(d)
            continue
        vert_req = local_req[local_req < g.n_nodes]
        replicas_at_d = int(
            (state.delta[vert_req, d] & (g.partition[vert_req] != d)).sum()
        )
        n_bs = _boundary_vertices(g, d)
        comm_proxy = n_iters * msg_bytes * (replicas_at_d + n_bs)
        local_size = float(sizes[local_req].sum())
        if comm_proxy - local_size > (1.0 - eta_l) * xi:
            excluded.append(d)
        else:
            retained.append(d)
    if not retained:  # degenerate: keep the DC with the most local data
        vols = [
            float(sizes[required_items[primary[required_items] == d]].sum())
            for d in range(D)
        ]
        retained = [int(np.argmax(vols))]
        excluded = [d for d in range(D) if d != retained[0]]

    retained_arr = np.asarray(sorted(retained))
    # --- bottom-up assembly -------------------------------------------------
    item_site = np.full(g.n_items, -1, dtype=np.int64)
    load = {int(d): 0.0 for d in retained}
    wan_bytes = 0.0
    migrated: List[np.ndarray] = []

    own = primary[required_items]
    keep = np.isin(own, retained_arr)
    # in-place: items whose primary DC is retained execute there
    item_site[required_items[keep]] = own[keep]
    for d in retained:
        load[d] += float(sizes[required_items[keep][own[keep] == d]].sum())

    # replica reuse: a displaced item already replicated at a retained DC
    pending = required_items[~keep]
    if len(pending):
        rep = state.delta[pending][:, retained_arr]
        has_rep = rep.any(axis=1)
        choice = retained_arr[np.argmax(rep, axis=1)]
        reuse = pending[has_rep]
        item_site[reuse] = choice[has_rep]
        pending = pending[~has_rep]

    # remaining items migrate: hash to retained DCs within the smallest
    # enclosing cluster, escalating per layer (Fig. 6 bottom-up)
    if len(pending):
        for x in pending.tolist():
            home = int(primary[x])
            dest = -1
            for layer in range(1, lg.n_layers + 1):
                comp = lg.comp_of_dc[layer, home]
                cluster = np.where(lg.comp_of_dc[layer] == comp)[0]
                cands = [int(d) for d in cluster if d in load]
                if cands:
                    # minimize comm cost, tie-break on current load balance
                    costs = [
                        (env.c_net[home, d] * sizes[x] + 1e-12 * load[d], d)
                        for d in cands
                    ]
                    dest = min(costs)[1]
                    break
            if dest < 0:
                dest = int(retained_arr[0])
            item_site[x] = dest
            load[dest] += float(sizes[x])
            wan_bytes += float(sizes[x])
        migrated.append(pending)

    migrated_arr = (
        np.concatenate(migrated) if migrated else np.zeros(0, dtype=np.int64)
    )
    return OfflineLayout(
        sites=retained_arr,
        item_site=item_site,
        migrated=migrated_arr,
        wan_bytes=wan_bytes,
        excluded=np.asarray(sorted(excluded)),
    )
