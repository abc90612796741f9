"""The check that decides ``correct``: the reference replays a run's log.

From the inputs the benchmark made (never from the program's arrays), the
reference works out the replica sets of the store's build with its own
placement (``placement.py``) on the CPU, replays the batches of inserts
the run acknowledged (``replay.py``), and routes every read of the run's
log with its own router (``route.py``) over the replica sets of the epoch
its drain was served in, for the items its pattern had when the read was
sent.  It compares:

* ``graph_rows_differing`` (runs with inserts): items of the store's final
  graph, matched by uid, whose endpoints, bytes or partition differ from
  the replay's, or that one side lacks (exact);
* ``replica_rows_differing``: item rows whose replica set differs from the
  program's at the end: the build's, grown by the batches' primaries
  (exact);
* ``served_by_mismatches``: reads of the kept drains whose serving DC of
  some item, or whose set of serving DCs, differs (exact);
* ``latency_rel_gap``: the largest relative gap of a read's Eq. 1 latency
  (every answered read) or of a serving DC's (kept drains);
* ``payload_rows_differing``: in a sharded store, rows of a shard's payload
  block that differ from the rows its DCs hold, each a function of the
  item's uid (exact).
"""
from __future__ import annotations

import time

import numpy as np

from .placement import PlacementParams, place
from .replay import Replay, graph_rows, rows_differing_by_uid
from .route import Router

__all__ = ["LIMITS", "check_run", "payload_rows", "judge"]

# The limit of each compared number (PERF.md gives the readings each was
# set from).  Counts are exact.  Latency sums a DC's item bytes in float64
# on both sides (a read routed alone in float32), in another order.
LIMITS = {
    "graph_rows_differing": 0,
    "replica_rows_differing": 0,
    "served_by_mismatches": 0,
    "latency_rel_gap": 1e-12,
    "payload_rows_differing": 0,
}


def payload_rows(uids: np.ndarray, width: int) -> np.ndarray:
    """A shard's payload row of each item: a multiplicative mix of the
    item's stable uid, in ``[0, 1)``."""
    uids = np.asarray(uids, np.int64)
    cols = np.arange(1, width + 1, dtype=np.int64)
    mix = (uids[:, None] * 2654435761 + cols[None, :] * 40503) & 0xFFFF
    return (mix / 65536.0).astype(np.float32)


def _rows_differing(a: np.ndarray, b: np.ndarray) -> int:
    if a.shape != b.shape:
        return max(a.shape[0], b.shape[0])
    return int((a != b).any(axis=1).sum())


def _lone(origins: list, sharded: bool) -> list:
    """Which reads of a drain the store routes alone: the one read of a
    drain of one, or in a sharded store the one read of its origin."""
    if not sharded:
        return [len(origins) == 1] * len(origins)
    counts: dict = {}
    for o in origins:
        counts[o] = counts.get(o, 0) + 1
    return [counts[o] == 1 for o in origins]


def judge(config, inputs, log, delta: np.ndarray) -> list:
    """``[(name, value, limit)]`` of the run logged in ``log`` against the
    replica sets ``delta`` of the build."""
    g, env = inputs.g, inputs.env
    replay = Replay(g, delta, inputs.patterns, env.rtt_s)
    router = Router(replay.sizes(), env.rtt_s, env.bw_Bps, replay.comp())
    router.set_replicas(replay.delta)
    batches = log.batches
    version = np.zeros(len(log.pattern), np.int64) if log.version is None else log.version
    epochs = [0] * len(log.drains) if log.drain_epoch is None else log.drain_epoch
    sharded = config["store"]["kind"] == "sharded"

    def answer(i: int, lone: bool) -> tuple:
        p, v, o = int(log.pattern[i]), int(version[i]), int(log.origin[i])
        return router.route_items((p, v, o, lone), lambda: replay.items_at(p, v), o, lone)

    def advance(epoch: int) -> None:
        while replay.epoch < epoch:
            replay.apply(batches[replay.epoch])
            router.set_replicas(replay.delta, replay.sizes(), replay.comp())

    want_lat = np.full(len(log.pattern), np.nan)
    mismatches, gap, n_kept = 0, 0.0, 0
    for drain_no, ids in enumerate(log.drains):
        advance(epochs[drain_no])
        org = log.origin[ids].tolist()
        lone = _lone(org, sharded)
        want_lat[ids] = [answer(i, lo)[3] for i, lo in zip(ids.tolist(), lone)]
        lone_of = dict(zip(ids.tolist(), lone))
        for i, served, dcs, lat in log.kept.get(drain_no, ()):
            n_kept += 1
            w_served, w_dcs, w_lat, _ = answer(i, lone_of[i])
            if not (np.array_equal(served, w_served) and np.array_equal(dcs, w_dcs)):
                mismatches += 1
                continue
            rel = np.abs(lat - w_lat) / np.maximum(np.abs(w_lat), 1e-12)
            gap = max(gap, float(rel.max(initial=0.0)))
    advance(len(batches))
    got = log.latency_eq1
    ok = log.answered & ~np.isnan(want_lat)
    rel = np.abs(got[ok] - want_lat[ok]) / np.maximum(np.abs(want_lat[ok]), 1e-12)
    gap = max(gap, float(rel.max(initial=0.0)))
    out = []
    if log.graph is not None:
        out.append(("graph_rows_differing",
                    rows_differing_by_uid(replay.graph_rows(), graph_rows(*log.graph)),
                    LIMITS["graph_rows_differing"]))
    out += [
        ("replica_rows_differing", _rows_differing(replay.delta, log.delta),
         LIMITS["replica_rows_differing"]),
        ("served_by_mismatches", mismatches, LIMITS["served_by_mismatches"]),
        ("latency_rel_gap", gap, LIMITS["latency_rel_gap"]),
    ]
    if log.payload is not None:
        n_shards = config["store"]["n_shards"]
        base = payload_rows(replay.uid, log.payload[0].shape[1])
        bad = 0
        for sid, block in enumerate(log.payload):
            dcs = [d for d in range(env.n_dcs) if d % n_shards == sid]
            bad += _rows_differing(block, base * replay.delta[:, dcs].any(axis=1)[:, None])
        out.append(("payload_rows_differing", bad, LIMITS["payload_rows_differing"]))
    print(f"reference: {int(ok.sum())} read latencies and {n_kept} kept answers compared "
          f"over {len(log.drains)} drains and {len(batches)} batches of inserts", flush=True)
    return out


def check_run(config: dict, inputs, log) -> list:
    """``[(name, value, limit)]`` for the run whose log is ``log``."""
    t0 = time.perf_counter()
    delta = place(inputs.g, inputs.env, inputs.patterns,
                  PlacementParams(**config.get("placement", {})))
    t1 = time.perf_counter()
    out = judge(config, inputs, log, delta)
    print(f"reference: placement {t1 - t0:.3f} s, routing and compare "
          f"{time.perf_counter() - t1:.3f} s", flush=True)
    return out
