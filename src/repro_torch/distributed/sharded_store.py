"""ShardedGeoGraphStore — the multi-shard data plane over the devices.

One :class:`~repro_torch.core.store.GeoGraphStore` becomes per-DC **store
shards** laid over the devices (the mesh-as-geo mapping of
:mod:`repro_torch.distributed.geo_sharding`: shards = DCs).  With fewer
cards than shards the mapping cycles: on one card every shard lives on
``cuda:0`` (identical results, payload transfers are same-device copies),
and with ``device="cpu"`` every shard lives on the host.

Three planes, split by what must stay authoritative where:

* **metadata / control plane** — placement, mutation, compaction and
  migration *planning* stay on an inner ``GeoGraphStore`` coordinator (on
  ``device``, where its DHD kernels run), so
  replica sets are identical to the single-process store by construction.
  The full store kernel API (``serve_batch`` / ``apply_updates`` /
  ``flush_migrations`` / ``begin_flush`` / ``maintain`` / ``compact``)
  is preserved, so ``serve/`` and ``streaming/`` callers work unchanged.
* **routing plane** — each shard owns a :class:`~repro_torch.core.route_index.
  RoutePartition` per origin DC, kept in sync by the coordinator
  :class:`~repro_torch.core.route_index.RouteIndex`'s change events.  Partitions
  re-derive their rows independently from the replicated placement map, so
  shard/coordinator divergence is detectable (``verify_partitions``), and
  ``serve_batch`` dispatches per-origin sub-batches to the owning shard —
  which makes every sub-batch single-origin and lands it on
  ``route_online_batch``'s specialized expansion path, on the shard's
  device (the route-expansion kernel on the card).
* **payload plane** — each shard holds a ``torch.float32 [I, width]``
  block on its device for the items replicated at its DCs.  Row content is a pure
  function of the item's content-stable uid (:func:`payload_for_uids`), so
  shards materialize rows locally at placement time, and migration waves
  ship rows as explicit device-to-device transfers
  (:func:`~repro_torch.distributed.collectives.transfer_rows`, optionally int8)
  whose wire bytes land in per-shard ``MatrixCounter`` grids.

Per-shard :class:`~repro_torch.obs.MetricsRegistry` snapshots fold into one
view via :meth:`~repro_torch.obs.MetricsRegistry.merge` (``merged_metrics``),
and each shard's measured serve wall time feeds a
:class:`~repro_torch.distributed.fault.StragglerDetector` the admission
controller reads for per-shard miss attribution.  Where the shards span two
or more devices they dispatch on a thread pool, so several threads may
launch kernels at once and overlap their waits for their own cards; where
every shard shares one device (one card, or the host) the sub-batches are
routed one after another on the calling thread, since threads there would
only contend for the interpreter lock.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.patterns import Pattern
from ..core.route_index import RoutePartition
from ..core.routing import RouteResult, route_online_batch
from ..core.store import GeoGraphStore
from ..device import DeviceLike
from ..obs import MetricsRegistry
from .collectives import transfer_rows
from .fault import StragglerDetector
from .geo_sharding import mesh_devices

__all__ = ["ShardedGeoGraphStore", "StoreShard", "payload_for_uids"]

PAYLOAD_WIDTH = 8


def payload_for_uids(uids: np.ndarray, width: int = PAYLOAD_WIDTH) -> np.ndarray:
    """Deterministic ``[len(uids), width]`` float32 payload rows.

    Row content is a pure function of the item's content-stable uid (a
    Knuth-style multiplicative mix), so any shard can materialize or verify
    a row without consulting a central copy, and rows survive compaction
    (uids are row-selected, never renumbered).  Values lie in ``[0, 1)``,
    which keeps the int8 transfer path's quantization error bounded by
    ``~1/254``.
    """
    uids = np.asarray(uids, dtype=np.int64)
    cols = np.arange(1, width + 1, dtype=np.int64)
    mix = (uids[:, None] * 2654435761 + cols[None, :] * 40503) & 0xFFFF
    return (mix / 65536.0).astype(np.float32)


def _dispatch_on_pool(devices: Sequence[torch.device]) -> bool:
    """Whether the shards' sub-batches go to a thread pool: only when the
    shards sit on two or more distinct devices, whose readbacks release the
    interpreter lock and so can overlap.  On one device the threads would
    only take turns with the lock."""
    return len(set(devices)) > 1


def _synchronize(devices) -> None:
    """Wait for the queued work of every CUDA device in ``devices``."""
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class StoreShard:
    """One shard of the data plane: a set of origin DCs, their route
    partitions, a payload block on the shard's device, and a private
    registry."""

    __slots__ = ("sid", "dcs", "device", "registry", "partitions", "payload")

    def __init__(self, sid: int, dcs: Sequence[int], device, registry) -> None:
        self.sid = int(sid)
        self.dcs = [int(d) for d in dcs]
        self.device = device
        self.registry = registry
        self.partitions: Dict[int, RoutePartition] = {}
        self.payload: Optional[torch.Tensor] = None  # [I, width] f32 on self.device

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"StoreShard(sid={self.sid}, dcs={self.dcs}, device={self.device})"


class _ShardedWaveApplier:
    """:class:`~repro_torch.streaming.migration.WaveApplier` proxy that lands each
    wave's payload as device-to-device transfers *before* the metadata
    (placement + route-index) patch applies — data first, routes flip after.

    Staleness is checked up front (``check_valid``) so no payload ships for
    a wave whose item rows were renumbered under the flush."""

    def __init__(self, owner: "ShardedGeoGraphStore", applier) -> None:
        self._owner = owner
        self._applier = applier

    @property
    def plan(self):
        return self._applier.plan

    @property
    def schedule(self):
        return self._applier.schedule

    @property
    def n_remaining(self) -> int:
        return self._applier.n_remaining

    @property
    def done(self) -> bool:
        return self._applier.done

    def peek(self):
        return self._applier.peek()

    def apply_next(self):
        self._applier.check_valid()
        wave = self._applier.peek()
        if wave is not None:
            self._owner._execute_wave(wave)
        return self._applier.apply_next()

    def finish(self):
        out = self._applier.finish()
        # drops (including any constraint-guard rollback) are final now:
        # zero the payload rows each shard no longer holds
        self._owner._apply_drops_payload()
        return out


class ShardedGeoGraphStore:
    """Per-DC store shards over the devices, behind the store kernel API.

    ``n_shards`` defaults to one shard per DC; fewer shards group DCs
    round-robin (``dc % n_shards``), so the same environment can be served
    at 1/2/4/8 shards with identical replica sets and routes — the
    differential invariant ``tests/test_sharded_store.py`` pins down.

    Unknown attributes delegate to the inner coordinator store, so existing
    control-plane code (:class:`~repro_torch.serve.AdmissionController`,
    :class:`~repro_torch.serve.MaintenancePolicy`) drives a sharded store
    unmodified.

    Parameters beyond the ``GeoGraphStore`` ones:

    * ``device`` — where the coordinator runs (``None`` = the card,
      ``"cpu"`` = the host), passed to the inner ``GeoGraphStore``.
    * ``n_shards`` / ``devices`` — mesh layout (devices default to
      :func:`~repro_torch.distributed.geo_sharding.mesh_devices` of
      ``device``).
    * ``parallel`` — dispatch per-shard sub-batches on a thread pool
      (default: only when the shards sit on two or more distinct devices;
      on one device they are routed on the calling thread).
    * ``payload_width`` / ``compress`` — payload row width and the optional
      ``"int8"`` wire compression for migration transfers.
    * ``telemetry`` — start the per-shard registries enabled.
    * ``fetch_payload`` — have ``serve_batch`` also gather the served rows
      from the owning shard's device payload (end-to-end read path).
    """

    def __init__(
        self,
        g,
        env,
        workload,
        config=None,
        n_shards: Optional[int] = None,
        devices: Optional[Sequence] = None,
        parallel: Optional[bool] = None,
        payload_width: int = PAYLOAD_WIDTH,
        compress: Optional[str] = None,
        telemetry: bool = False,
        straggler_threshold: float = 1.8,
        fetch_payload: bool = False,
        device: DeviceLike = None,
        **store_kw,
    ) -> None:
        routing = store_kw.setdefault("routing", "stepwise")
        if routing != "stepwise":
            raise ValueError(
                "ShardedGeoGraphStore partitions the nearest-replica route "
                f"index; routing={routing!r} has no per-origin partition"
            )
        if compress not in (None, "int8"):
            raise ValueError(f"unknown compression {compress!r} (None or 'int8')")
        self._store = GeoGraphStore(
            g, env, workload, config=config, device=device, **store_kw
        )
        D = env.n_dcs
        self.n_shards = D if n_shards is None else int(n_shards)
        if not 1 <= self.n_shards <= D:
            raise ValueError(f"n_shards must be in [1, {D}], got {self.n_shards}")
        self.payload_width = int(payload_width)
        self.compress = compress
        self.fetch_payload = bool(fetch_payload)
        devices = (
            mesh_devices(self.n_shards, self._store.device)
            if devices is None else [torch.device(d) for d in devices]
        )
        self.origin_shard: Dict[int, int] = {
            d: d % self.n_shards for d in range(D)
        }
        self.registry = MetricsRegistry(enabled=telemetry)
        self.shards: List[StoreShard] = []
        self.partitions: Dict[int, RoutePartition] = {}
        delta_fn = lambda: self._store.state.delta  # noqa: E731 - live provider
        for sid in range(self.n_shards):
            shard = StoreShard(
                sid,
                [d for d in range(D) if d % self.n_shards == sid],
                devices[sid % len(devices)],
                MetricsRegistry(enabled=telemetry),
            )
            for d in shard.dcs:
                part = RoutePartition(env, d, delta_fn)
                shard.partitions[d] = part
                self.partitions[d] = part
            self.shards.append(shard)
            self._store.route_tables.add_device(shard.device)
        self._bound_index = None
        self._rebind_index()
        self.straggler = StragglerDetector(
            self.n_shards, threshold=straggler_threshold
        )
        # each shard's wall seconds in the last serve_batch, on the thread
        # that routed it (the calling thread, or a pool thread, whose waits
        # for the interpreter lock then count too), the device's included
        self.last_shard_seconds: Dict[int, float] = {}
        # makespan of the last serve_batch (slowest shard's busy seconds):
        # shards are independent hosts, so this — not the coordinator's wall
        # time — is what the "measured" admission service model charges.
        # Owned by the facade (declared pre-_init_done) so it shadows the
        # inner store's per-sub-batch wall clock.
        self.last_serve_seconds = 0.0
        if parallel is None:
            parallel = _dispatch_on_pool([shard.device for shard in self.shards])
        self._pool = (
            ThreadPoolExecutor(max_workers=self.n_shards) if parallel else None
        )
        self._init_done = True

    # any attribute the sharded facade does not own itself comes from (and
    # goes to) the coordinator — state, lg, _delta_graph, cost(), ... — so
    # code written against GeoGraphStore reads *and writes* through cleanly
    def __getattr__(self, name: str):
        store = self.__dict__.get("_store")
        if store is None:
            raise AttributeError(name)
        return getattr(store, name)

    def __setattr__(self, name: str, value) -> None:
        if "_init_done" in self.__dict__ and name not in self.__dict__:
            setattr(self._store, name, value)
        else:
            object.__setattr__(self, name, value)

    # -------------------------------------------------------- routing plane
    def _rebind_index(self) -> None:
        """(Re-)attach the partitions to the coordinator's RouteIndex.

        ``insert_patterns`` re-places from scratch and builds a *new* index,
        which knows nothing of our listeners — detect the swap, re-subscribe,
        and re-derive every partition and payload block."""
        idx = self._store.route_index
        if idx is None:  # pragma: no cover - guarded by the ctor routing check
            raise RuntimeError("sharded store requires a RouteIndex")
        if idx is not self._bound_index:
            idx.subscribe(self._on_route_event)
            self._bound_index = idx
            for part in self.partitions.values():
                part.derive_all()
            self._sync_payloads()

    def _on_route_event(self, kind: str, payload: object) -> None:
        for part in self.partitions.values():
            part.on_event(kind, payload)

    def route_table(self) -> np.ndarray:
        """``[I, D]`` serving table column-stacked from the shard partitions
        (must equal the coordinator's ``state.route`` — the differential
        invariant)."""
        D = self._store.env.n_dcs
        return np.stack([self.partitions[d].nearest for d in range(D)], axis=1)

    def verify_partitions(self) -> bool:
        """True iff every shard partition equals its coordinator column."""
        idx = self._store.route_index
        return all(p.verify_against(idx) for p in self.partitions.values())

    # -------------------------------------------------------- payload plane
    def _base_payload(self) -> np.ndarray:
        return payload_for_uids(self._store._item_uid, self.payload_width)

    def _sync_payloads(self) -> None:
        """Rebuild every shard's device payload from the placement map (id
        space moved: mutation growth, compaction, full re-place)."""
        base = self._base_payload()
        delta = self._store.state.delta
        for shard in self.shards:
            mask = delta[:, shard.dcs].any(axis=1)
            shard.payload = torch.as_tensor(base * mask[:, None], device=shard.device)

    def _apply_drops_payload(self) -> None:
        """Zero payload rows a shard no longer holds (drops/evictions —
        same id space, narrower replica sets)."""
        delta = self._store.state.delta
        for shard in self.shards:
            mask = delta[:, shard.dcs].any(axis=1)
            if shard.payload is None or shard.payload.shape[0] != len(mask):
                return self._sync_payloads()
            keep = torch.as_tensor(
                mask[:, None].astype(np.float32), device=shard.device
            )
            shard.payload = shard.payload * keep

    def _execute_wave(self, wave) -> None:
        """Run one migration wave's transfers device-to-device, accounting
        wire bytes per link into the *source* shard's registry."""
        D = self._store.env.n_dcs
        t0 = time.perf_counter()
        touched: List[StoreShard] = []
        for b in wave.links:
            src_sh = self.shards[self.origin_shard[b.src]]
            dst_sh = self.shards[self.origin_shard[b.dst]]
            rows = np.asarray(b.items, dtype=np.int64)
            block, wire = transfer_rows(
                src_sh.payload, rows, dst_sh.device, compress=self.compress
            )
            # the gather above copied the rows out, so writing the
            # destination in place is safe when both shards are one
            dst_sh.payload.index_copy_(
                0, torch.as_tensor(rows, device=dst_sh.device), block
            )
            touched.append(dst_sh)
            if src_sh.registry.enabled:
                mat = np.zeros((D, D))
                mat[b.src, b.dst] = wire
                src_sh.registry.counter_grid(
                    "migration.device_bytes_link", ("src", "dst")
                ).add(mat)
        _synchronize({sh.device for sh in touched})
        if self.registry.enabled:
            self.registry.histogram("migration.device_wave_s").observe(
                time.perf_counter() - t0
            )
            self.registry.counter("migration.device_waves").inc()

    def verify_payloads(self) -> float:
        """Max abs deviation of any *held* payload row from its uid-derived
        content, across shards (0.0 exact; <~1/127 under int8 transfers)."""
        base = self._base_payload()
        delta = self._store.state.delta
        worst = 0.0
        for shard in self.shards:
            mask = delta[:, shard.dcs].any(axis=1)
            if not mask.any():
                continue
            got = shard.payload.cpu().numpy()[mask]
            err = np.abs(got - base[mask]).max()
            worst = max(worst, float(err))
        return worst

    # -------------------------------------------------------------- serving
    def serve_online(self, pattern, origin: int) -> RouteResult:
        """Serve one online pattern request through the owning shard."""
        return self.serve_batch([(pattern, origin)])[0]

    def serve_batch(
        self,
        requests: Sequence[Tuple[object, int]],
        observe: bool = True,
    ) -> List[RouteResult]:
        """Serve a batch by dispatching per-origin sub-batches to the owning
        shards and merging results back in input order.

        Requests are independent in the batch router, so the grouped
        dispatch is request-for-request identical to the single-process
        ``serve_batch`` on the same inputs.  Single-origin sub-batches land
        on ``route_online_batch``'s specialized expansion path.  With a pool
        (shards on two or more devices, or ``parallel=True``) and more than
        one origin, the sub-batches run on its threads; otherwise they are
        routed in origin order on the calling thread.  Each shard's seconds
        per call (summed over its origin sub-batches) feed the straggler
        detector and ``last_shard_seconds``: wall seconds on the thread that
        routed it, which include the wait for the device and, on a pool
        thread, the waits for the interpreter lock.  ``last_serve_seconds``
        is the slowest shard's, the makespan of hosts that each serve one
        DC.  With ``fetch_payload`` the served rows are also gathered from
        the owning shard's device block.

        The inner store's tracer records one ``facade.serve_batch`` span
        per call (tags ``size``, ``n_origins``) with the children
        ``facade.split``, ``facade.pool_wait`` (the whole dispatch, tag
        ``dispatch``: ``"pool"`` or ``"inline"``), ``facade.merge``,
        ``facade.fetch_rows`` and ``facade.observe``, and one
        ``shard.route`` per origin sub-batch on the thread that routes it,
        parented to the ``facade.serve_batch`` span (tags ``shard``,
        ``origin``, ``reads``, and ``cpu_s``, that thread's CPU seconds
        in it)."""
        tr = self._store.tracer
        with tr.span("facade.serve_batch", track="facade") as root:
            with tr.span("facade.split", track="facade"):
                norm: List[Tuple[np.ndarray, int]] = []
                for req, origin in requests:
                    items = req.items if isinstance(req, Pattern) else np.asarray(req)
                    norm.append((items, int(origin)))
                R = len(norm)
                results: List[Optional[RouteResult]] = [None] * R
                by_origin: Dict[int, List[int]] = {}
                for pos, (_, o) in enumerate(norm):
                    by_origin.setdefault(o, []).append(pos)
                jobs = sorted(by_origin.items())
            root.tag(size=R, n_origins=len(jobs))
            pooled = self._pool is not None and len(jobs) > 1
            with tr.span("facade.pool_wait", track="facade",
                         dispatch="pool" if pooled else "inline"):
                if pooled:
                    futs = [
                        (o, pos, self._pool.submit(
                            self._serve_origin, o, [norm[p] for p in pos], root.sid
                        ))
                        for o, pos in jobs
                    ]
                    outs = [(o, pos, f.result()) for o, pos, f in futs]
                else:
                    outs = [
                        (o, pos, self._serve_origin(o, [norm[p] for p in pos], root.sid))
                        for o, pos in jobs
                    ]
            with tr.span("facade.merge", track="facade"):
                busy: Dict[int, float] = {}
                for o, pos_list, (res, dt) in outs:
                    sid = self.origin_shard[o]
                    busy[sid] = busy.get(sid, 0.0) + dt
                    for p, r in zip(pos_list, res):
                        results[p] = r
                for sid in sorted(busy):
                    self.straggler.observe(sid, busy[sid])
                self.last_shard_seconds = busy
                self.last_serve_seconds = max(busy.values(), default=0.0)
            if self.fetch_payload:
                with tr.span("facade.fetch_rows", track="facade"):
                    self._fetch_rows(jobs, norm)
            if observe and norm:
                # heat injection grouped per origin into the shared demand
                # plane, exactly like the inner store
                with tr.span("facade.observe", track="facade"):
                    for o, pos_list in by_origin.items():
                        self._store.demand.observe(
                            np.concatenate([norm[p][0] for p in pos_list]), origin=o
                        )
        return results

    def _serve_origin(
        self, origin: int, sub: List[Tuple[np.ndarray, int]], parent: Optional[int],
    ) -> Tuple[List[RouteResult], float]:
        """Route one origin's sub-batch on its owning shard, telemetry into
        that shard's registry and a ``shard.route`` span under ``parent``,
        with the coordinator's route tables for the shard's device (item
        bytes on the host, bitmasks and bytes keyed by item id on the
        device);
        returns results + wall seconds."""
        shard = self.shards[self.origin_shard[origin]]
        tr = self._store.tracer
        with tr.span("shard.route", track="shard", parent=parent, shard=shard.sid,
                     origin=origin, reads=len(sub)) as span:
            cpu0 = time.thread_time() if tr.enabled else 0.0
            t0 = time.perf_counter()
            sizes, tables = self._store.route_tables.handed(self._store.route_index,
                                                            shard.device)
            res = route_online_batch(
                self._store.lg, self._store.state, sub, sizes=sizes, registry=shard.registry,
                device=shard.device, tracer=tr, tables=tables,
            )
            dt = time.perf_counter() - t0
            if tr.enabled:
                span.tag(cpu_s=time.thread_time() - cpu0)
        return res, dt

    def _fetch_rows(
        self, jobs: List[Tuple[int, List[int]]], norm: List[Tuple[np.ndarray, int]]
    ) -> None:
        """Gather each sub-batch's rows from the owning shard's device
        payload (async dispatch, one synchronise at the end)."""
        devices = set()
        for o, pos_list in jobs:
            idx = np.concatenate([norm[p][0] for p in pos_list])
            if len(idx) == 0:
                continue
            payload = self.shards[self.origin_shard[o]].payload
            idx_t = torch.as_tensor(idx.astype(np.int64), device=payload.device)
            payload.index_select(0, idx_t).sum()
            devices.add(payload.device)
        _synchronize(devices)

    # ---------------------------------------------------------- maintenance
    def apply_updates(self, batch):
        report = self._store.apply_updates(batch)
        # partitions followed the index events; the id space moved, so the
        # payload blocks re-materialize from the new uid/placement rows
        self._sync_payloads()
        return report

    def maintain(self, evict: bool = True, diffusion_steps: int = 4):
        out = self._store.maintain(evict=evict, diffusion_steps=diffusion_steps)
        self._apply_drops_payload()
        return out

    def delete_items(self, item_ids: np.ndarray) -> None:
        self._store.delete_items(item_ids)
        self._apply_drops_payload()

    def compact(self) -> bool:
        fired = self._store.compact()
        if fired:
            self._sync_payloads()
        return fired

    def insert_patterns(self, new_patterns) -> None:
        self._store.insert_patterns(new_patterns)
        self._rebind_index()

    def insert_patterns_incremental(self, new_patterns):
        out = self._store.insert_patterns_incremental(new_patterns)
        self._rebind_index()
        return out

    # ------------------------------------------------------------ migration
    def begin_flush(
        self,
        budget_bytes: Optional[float] = None,
        window_s: float = 60.0,
        schedule: str = "ff",
        **kw,
    ):
        """Like the coordinator's ``begin_flush``, but the returned applier
        ships each wave's payload device-to-device before its metadata
        lands."""
        plan, applier = self._store.begin_flush(
            budget_bytes, window_s, schedule=schedule, **kw
        )
        return plan, _ShardedWaveApplier(self, applier)

    def flush_migrations(
        self,
        budget_bytes: Optional[float] = None,
        window_s: Optional[float] = 60.0,
        on_wave=None,
        schedule: str = "ff",
        **kw,
    ):
        if window_s is None:
            # legacy single-shot path: no wave structure to ship, so the
            # payload re-materializes from the final placement instead
            plan = self._store.flush_migrations(
                budget_bytes, window_s, on_wave=on_wave, schedule=schedule, **kw
            )
            self._sync_payloads()
            return plan
        plan, applier = self.begin_flush(
            budget_bytes, window_s, schedule=schedule, **kw
        )
        while applier.n_remaining:
            wave = applier.apply_next()
            if on_wave is not None:
                on_wave(wave)
        applier.finish()
        return plan

    # -------------------------------------------------------------- metrics
    def enable_telemetry(self) -> "ShardedGeoGraphStore":
        self.registry.enable()
        for shard in self.shards:
            shard.registry.enable()
        return self

    def merged_metrics(self) -> dict:
        """One exportable snapshot: coordinator + every shard registry,
        folded by :meth:`~repro_torch.obs.MetricsRegistry.merge`."""
        snaps = [self.registry.snapshot()]
        snaps += [shard.registry.snapshot() for shard in self.shards]
        return MetricsRegistry.merge(snaps)
