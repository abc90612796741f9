"""One run of one benchmark cell: set-up, an open-loop window, the check.

``run_cell`` builds the cell's store from the seed's inputs, warms every
path the window will run, then drives the port's admission controller
(``repro_torch.serve.scheduler.AdmissionController``) on a wall clock with
open-loop reads for ``seconds`` seconds.  Reads fall due as the mix's
Poisson stream says, whatever the store does; the clients keep at most the
mix's ``max_outstanding`` reads in the store at once, and a due read beyond
that waits at its client, its time running from when it was due.  The
harness logs every drain, hands the log to the reference once the window
has closed, and returns the result line.

A mix with a ``"writes"`` block also hands the store each sealed batch of
inserts when it falls due, between controller steps, through the store's
own ``apply_updates`` (the controller has no write queue); a write is
acknowledged when that call returns.  The warm-up's batches are applied
before the warm-up's reads.  After each batch the harness moves its
catalog of patterns to the new ids and grows each neighbourhood the
batch's edges reach (``catalog.py``), so reads due from then on read the
new friends; reads already in the store are re-keyed by the program's
remap listener.  The
log keeps each batch, its acknowledgement, the batches applied when each
read was sent and when each drain was served, and the store's final graph
and item uids.  A mix without the block runs as it did before writes
existed.

``device`` is ``"cuda"`` for a measured run; the CPU tests call it with
``"cpu"`` and a small configuration.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import pathlib
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from . import stats
from .clock import WallClock
from .inputs import make_inputs, to_port, to_port_batch
from .traffic import load_mix, make_reads, make_writes, warmup_reads

__all__ = ["Cell", "resolve_cell", "run_cell", "window_mask", "banned_modules", "BANNED"]

GEOBENCH = pathlib.Path(__file__).resolve().parent
ROOT = GEOBENCH.parent
# top-level module names no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# share of drains whose every answer is kept for the reference (the rest
# are judged by their latency alone)
SAMPLE_SHARE = 0.25
POST_WINDOW_S = 60.0  # how long unanswered window reads are waited for
PROFILE_S = 2.0  # length of the profiled sub-window in a traced run


def window_mask(due_abs: np.ndarray, end: float) -> np.ndarray:
    """Reads due in the window: before its end, and not the warm-up's
    (due at ``-inf``), which the tail would count as infinitely late."""
    return np.isfinite(due_abs) & (due_abs < end)


def banned_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(BANNED))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def resolve_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    mix files, found by the names the cell gives."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    return Cell(
        name=name, config=config, mix=load_mix(cell["traffic"]), chips=int(cell["chips"]),
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name),
    )


# ------------------------------------------------------------------ program
class _Probe:
    """Stands between the controller and the store: times each
    ``serve_batch`` on the wall clock and keeps the sharded store's per-shard
    seconds.  Every other attribute is the store's own."""

    def __init__(self, store, sharded: bool) -> None:
        self._store = store
        self._sharded = sharded
        self.spans: List[tuple] = []  # (t0, t1, shard seconds summed)

    def serve_batch(self, requests, observe: bool = True):
        t0 = time.perf_counter()
        out = self._store.serve_batch(requests, observe)
        t1 = time.perf_counter()
        shard_s = sum(self._store.last_shard_seconds.values()) if self._sharded else 0.0
        self.spans.append((t0, t1, shard_s))
        return out

    def __getattr__(self, name: str):
        return getattr(self._store, name)


def build_store(config: dict, inputs, device: str, tracer=None):
    """The configuration's store on ``device``.  Where the configuration
    says ``"placement_device": "cpu"``, the port works out the build's
    replica sets on the host and the store on ``device`` adopts them."""
    from repro_torch.core.placement import PlacementConfig

    g, env, wl = to_port(inputs)
    sc = config["store"]
    pcfg = PlacementConfig(**config.get("placement", {}))
    kw = {}
    if sc.get("placement_device") == "cpu":
        from repro_torch.core.layered_graph import build_layered_graph
        from repro_torch.core.placement import overlap_centric_placement

        kw["state"], _ = overlap_centric_placement(build_layered_graph(g, env), wl, pcfg,
                                                   device="cpu")
    if sc["kind"] == "flat":
        from repro_torch.core.store import GeoGraphStore

        return GeoGraphStore(g, env, wl, config=pcfg, device=device, tracer=tracer, **kw)
    if sc["kind"] == "sharded":
        from repro_torch.distributed.sharded_store import ShardedGeoGraphStore

        return ShardedGeoGraphStore(
            g, env, wl, config=pcfg, n_shards=sc["n_shards"],
            fetch_payload=sc["fetch_payload"], payload_width=sc["payload_width"],
            compress=sc["compress"], device=device, tracer=tracer, **kw,
        )
    raise ValueError(f"unknown store kind {sc['kind']!r}")


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


@dataclasses.dataclass
class RunLog:
    """Everything the reference needs, in the order it happened."""

    pattern: np.ndarray  # [N] every read, warm-up first
    origin: np.ndarray
    drains: list  # each drain's read ids, in order
    kept: Dict[int, list]  # drain number -> [(read id, served_by, dcs, lat)]
    latency_eq1: np.ndarray  # [N] the program's Eq. 1 latency of each read
    answered: np.ndarray  # [N] bool
    delta: Optional[np.ndarray] = None  # the program's replica sets
    payload: Optional[list] = None  # sharded: each shard's block at the end
    batches: list = dataclasses.field(default_factory=list)  # applied, in order
    acks: list = dataclasses.field(default_factory=list)  # clock s each apply returned
    version: Optional[np.ndarray] = None  # [N] batches applied when each read was sent
    drain_epoch: Optional[list] = None  # batches applied when each drain was served
    graph: Optional[tuple] = None  # the program's final graph rows (graph_rows' args)


class _Timeline:
    """Harness spans on ``perf_counter`` (traced runs only)."""

    def __init__(self) -> None:
        self.spans: List[tuple] = []  # (label, t0, t1)

    def add(self, label: str, t0: float, t1: float) -> None:
        self.spans.append((label, t0, t1))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: Optional[float] = None) -> dict:
    """One run; returns the result line's object (``correct`` ... ``checks``)."""
    t_process = time.perf_counter() if t_process is None else t_process
    import torch

    from repro_torch.obs import Tracer
    from repro_torch.serve.scheduler import AdmissionConfig, AdmissionController

    config, mix = cell.config, cell.mix
    if "writes" in mix and config["patterns"].get("direction", "both") != "both":
        raise ValueError("a mix with writes needs reads walked both ways: the catalog and "
                         "the reference grow whole undirected neighbourhoods")
    sharded = config["store"]["kind"] == "sharded"
    inputs = make_inputs(config, seed)
    pats = inputs.patterns
    eligible = np.array([i for i, p in enumerate(pats) if len(p.items)], np.int64)
    home = np.array([int(np.argmax(p.r_py)) for p in pats], np.int64)
    D = inputs.env.n_dcs

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tracer = Tracer(clock=time.perf_counter, enabled=True) if trace else None
    store = build_store(config, inputs, device, tracer=tracer)
    probe = _Probe(store, sharded)
    clock = WallClock()
    ctl = AdmissionController(
        probe, AdmissionConfig(**config["admission"]), clock=clock,
        wall_clock=time.perf_counter,
    )
    cap = int(mix["max_outstanding"])

    # --------------------------------------------------------- the read stream
    sizes_w = [int(s) for s in mix["warmup_drains"]]
    n_warm = sum(sizes_w)
    w_pat, w_org = warmup_reads(mix["reads"], eligible, home, D, seed, n_warm)
    stream = make_reads(mix["reads"], eligible, home, D, seed, seconds)
    N = n_warm + len(stream.due)
    pattern = np.concatenate([w_pat, stream.pattern])
    origin = np.concatenate([w_org, stream.origin])
    items = [p.items for p in pats]
    writes = mix.get("writes")
    batches = [] if writes is None else make_writes(
        writes, config["graph"], inputs.g, inputs.wiring, D, seed, seconds)
    n_batches = len(batches)
    if batches:
        from .catalog import Catalog

        catalog = Catalog(inputs.g, pats)
        items = catalog.items  # the catalog replaces its entries after each batch
    applies: List[dict] = []  # each batch applied: its times and mutations
    cuts: List[int] = []  # reads sent before each batch
    drain_cuts: List[int] = []  # drains served before each batch
    t_ret = np.full(N, np.nan)
    failed = np.zeros(N, bool)
    lat_eq1 = np.full(N, np.nan)
    drain_rng = np.random.default_rng([seed, 3])
    log = RunLog(pattern=pattern, origin=origin, drains=[], kept={},
                 latency_eq1=lat_eq1, answered=np.zeros(N, bool))
    steps: List[tuple] = []  # (t0, t1, reads served, in window)
    timeline = _Timeline() if trace else None

    def record(batch, t_done: float) -> None:
        batch = [h for h in batch if h.result is not None]  # unanswered stay open
        if not batch:
            return
        ids = np.fromiter((h.rid for h in batch), np.int64, count=len(batch))
        t_ret[ids] = t_done
        lat_eq1[ids] = [h.result.latency_s for h in batch]
        log.answered[ids] = True
        if drain_rng.random() < SAMPLE_SHARE:
            log.kept[len(log.drains)] = [
                (int(i), h.result.served_by.copy(), np.asarray(h.result.dcs).copy(),
                 np.asarray(list(h.result.per_dc_latency.values()), np.float64))
                for i, h in zip(ids.tolist(), batch)
            ]
        log.drains.append(ids)

    def apply(b: int, next_read: int) -> None:
        """Hand batch ``b`` to the store; acknowledged when the call returns."""
        batch = batches[b]
        port = to_port_batch(batch)
        t0 = time.perf_counter()
        store.apply_updates(port)
        _sync(device)
        t1 = time.perf_counter()
        catalog.apply(batch)
        t2 = time.perf_counter()
        applies.append(dict(t0=t0, t1=t1, ops=batch.n_ops))
        log.batches.append(batch)
        log.acks.append(t1 - clock.origin)
        cuts.append(next_read)
        drain_cuts.append(len(log.drains))
        if timeline is not None:
            timeline.add("apply", t0, t1)
            timeline.add("catalog", t1, t2)

    # ------------------------------------------------------------------ warm-up
    nb = 0  # batches applied
    while nb < n_batches and batches[nb].due <= 0.0:
        apply(nb, 0)
        nb += 1
    rid = 0
    for size in sizes_w:
        now = clock.now()
        for k in range(rid, rid + size):
            ctl.submit(items[pattern[k]], int(origin[k]), at=now)
        rid += size
        while ctl.pending:
            t0 = clock.now()
            batch = ctl.step()
            record(batch, clock.now())
            steps.append((t0, clock.now(), len(batch), False))
    if trace and device == "cuda":
        from .tracing import warm_profiler

        warm_profiler()
    _sync(device)
    # set-up's objects go to the collector's permanent generation, so a full
    # collection in the window does not walk them
    gc.collect()
    gc.freeze()
    # the library of kernels is loaded and every shape warm: the window opens
    T0 = clock.now()
    setup_s = time.perf_counter() - t_process
    end = T0 + seconds
    due_abs = np.concatenate([np.full(n_warm, -np.inf), T0 + stream.due])
    # the controller never waits past the window's end or the next batch
    clock.horizon = min(end, T0 + batches[nb].due) if nb < n_batches else end
    wait = np.zeros(N)  # how long each read waited at its client
    prof_at = T0 + 2.0 * math.floor(seconds / 4.0) if trace and device == "cuda" else math.inf
    prof = None
    window_failed = None

    # ------------------------------------------------------------------- window
    i = n_warm
    try:
        while True:
            now = clock.now()
            if now >= end:
                break
            if trace and prof is None and now >= prof_at:
                from .tracing import start_profile

                prof = start_profile()
            if prof is not None and not prof.stopped and time.perf_counter() >= (
                    prof.t_start + PROFILE_S):
                prof.stop()
            if nb < n_batches and now >= T0 + batches[nb].due:
                apply(nb, i)
                nb += 1
                clock.horizon = min(end, T0 + batches[nb].due) if nb < n_batches else end
                continue
            t0 = time.perf_counter()
            while i < N and due_abs[i] <= now and ctl.pending < cap:
                ctl.submit(items[pattern[i]], int(origin[i]), at=float(due_abs[i]))
                wait[i] = now - due_abs[i]
                i += 1
            if i < N and ctl.n_scheduled == 0 and ctl.pending < cap:
                ctl.submit(items[pattern[i]], int(origin[i]), at=float(due_abs[i]))
                i += 1
            t1 = time.perf_counter()
            batch = ctl.step()
            t_done = clock.now()
            record(batch, t_done)
            if timeline is not None:
                timeline.add("submit", t0, t1)
                timeline.add("step", t1, time.perf_counter())
            if batch:
                steps.append((t1 - clock.origin, t_done, len(batch), True))
    except Exception:  # a failed drain fails every read still open
        window_failed = traceback.format_exc()
        print(window_failed, file=sys.stderr)
    _sync(device)
    if prof is not None and not prof.stopped:
        prof.stop()
    in_window = window_mask(due_abs, end)
    if window_failed is not None:
        failed[in_window & np.isnan(t_ret)] = True
    lat = stats.read_latencies(due_abs[in_window], t_ret[in_window],
                               failed[in_window], end)
    n_attempted = int(in_window[n_warm:].sum())
    n_completed = int((t_ret[n_warm:] <= end).sum())
    window_steps = [s for s in steps if s[3] and s[1] <= end]
    pending_at_close = int(in_window[n_warm:].sum() - n_completed)

    # ------------------------------------- answer what is left, for the check
    clock.horizon = math.inf
    t_stop = clock.now() + POST_WINDOW_S
    if window_failed is None:
        try:
            while (i < N and due_abs[i] < end) or ctl.pending or ctl.n_scheduled:
                if clock.now() >= t_stop:
                    break
                while i < N and due_abs[i] < end and ctl.pending < cap:
                    ctl.submit(items[pattern[i]], int(origin[i]), at=float(due_abs[i]))
                    i += 1
                record(ctl.step(), clock.now())
        except Exception:
            window_failed = traceback.format_exc()
            print(window_failed, file=sys.stderr)
    _sync(device)

    # --------------------------------------------------------- device readings
    if device == "cuda":
        dev = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
        }
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    ctx = {
        "cell": cell, "seconds": seconds, "end": end, "T0": T0, "steps": window_steps,
        "probe": probe.spans, "clock_origin": clock.origin, "tracer": tracer,
        "timeline": timeline, "prof": prof, "sharded": sharded,
        "lat": lat, "n_completed": n_completed, "n_attempted": n_attempted,
    }
    if trace:
        from .tracing import device_summary, per_layer_values

        summary = device_summary(ctx) if prof is not None else None
        ctx["device"] = summary
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
        metrics = per_layer_values(cell, ctx)
    else:
        metrics = end_to_end_values(cell, ctx, setup_s)
    wait_w = wait[n_warm:][in_window[n_warm:]]
    print(f"client-side wait: mean {wait_w.mean() * 1e3:.4f} ms, p99 "
          f"{np.quantile(wait_w, 0.99) * 1e3:.4f} ms, max {wait_w.max() * 1e3:.4f} ms "
          f"over {len(wait_w)} reads; due but not answered at close {pending_at_close}; "
          f"drains in window {len(window_steps)}", flush=True)
    lat_f = lat[np.isfinite(lat)]
    if len(lat_f):
        q50, q95, q99 = np.quantile(lat_f, [0.5, 0.95, 0.99]) * 1e3
        print(f"read time of window reads: p50 {q50:.4f} ms, p95 {q95:.4f} ms, p99 "
              f"{q99:.4f} ms, max {lat_f.max() * 1e3:.4f} ms", flush=True)
    if batches:
        win = [a for a in applies if a["t0"] >= clock.origin + T0]
        print(f"inserts: {len(log.batches)} batches acknowledged ({len(win)} in the window, "
              f"{sum(a['ops'] for a in win)} mutations), apply_updates "
              f"{np.mean([a['t1'] - a['t0'] for a in win] or [0.0]) * 1e3:.4f} ms a batch",
              flush=True)
        log.version = np.searchsorted(np.asarray(cuts), np.arange(N), side="right")
        log.drain_epoch = np.searchsorted(np.asarray(drain_cuts), np.arange(len(log.drains)),
                                          side="right").tolist()
    eq1 = lat_eq1[n_warm:][log.answered[n_warm:]]
    if len(eq1):
        print(f"Eq. 1 WAN latency of answered reads: mean {eq1.mean() * 1e3:.4f} ms, "
              f"p95 {np.quantile(eq1, 0.95) * 1e3:.4f} ms (modelled, not a metric)",
              flush=True)

    # ------------------------------------------- the program's state, then free
    log.delta = store.state.delta.copy()
    if batches:
        pg = store.g
        log.graph = (int(pg.n_nodes), pg.src.copy(), pg.dst.copy(), pg.node_size.copy(),
                     pg.edge_size.copy(), pg.partition.copy(), store._item_uid.copy())
    if sharded:
        log.payload = [s.payload.detach().cpu().numpy() for s in store.shards]
        if store._pool is not None:
            store._pool.shutdown(wait=True)
    del ctl, probe, store
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    from .reference.check import check_run

    checks = check_run(config, inputs, log)
    if window_failed is not None:
        checks.insert(0, ("window_failures", 1, 0))
    unanswered = int((~log.answered[:n_warm + n_attempted]).sum())
    checks.append(("unanswered", unanswered, 0))
    correct = all(v <= lim for _, v, lim in checks)
    return {
        "correct": bool(correct),
        "attempted": n_attempted,
        "failed": int(failed[n_warm:][in_window[n_warm:]].sum()),
        "metrics": metrics,
        "device": dev,
        **({"breakdown": ctx["device"]["breakdown"]}
           if trace and ctx.get("device") else {}),
        "checks": {name: {"value": v, "limit": lim} for name, v, lim in checks},
    }


def end_to_end_values(cell: Cell, ctx: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics from an untraced run."""
    out = {}
    for m in cell.end_to_end:
        name = m["name"]
        if name == "setup_s":
            v = setup_s
        elif name == "read_rps":
            v = ctx["n_completed"] / ctx["seconds"]
        else:
            raise KeyError(f"no arithmetic for end-to-end metric {name!r}")
        out[name] = {"value": float(v), "unit": m["unit"]}
    return out
