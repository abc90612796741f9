"""The control of the check: the reference, one precision lower, in the
program's place, judged by the harness's own comparison.

    python3 geobench/control.py --workload <cell> --seeds 11,12,13 [--seconds S]

The store states float32 heat for its DHD diffusions and float64 sums of a
read's bytes for its Eq. 1 latencies.  The control takes the step down in
both, the step that would tempt a later change: the reference's placement
with every diffusion step's heat rounded to bfloat16, and its router with
every byte sum in float32.  For each seed it serves the cell's warm-up and
window reads (those of ``--seconds`` at the mix's rate, in drains of the
controller's ``max_batch``) from the control, applies the mix's batches of
inserts to it (the reference's replay, on the control's replica sets)
between them, logs them as a run logs the program's, and hands the log to
``reference.check.check_run``, which has to come out not correct.  It runs
on the host's CPU; the benchmark's runs never call it.
"""
import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return np.where(np.isnan(x), x, r.view(np.float32))


def control_run(cell, seed: int, seconds: float):
    """``(correct, checks)`` of the control in the program's place."""
    from geobench.harness import RunLog, SAMPLE_SHARE
    from geobench.inputs import make_inputs
    from geobench.reference.check import _lone, check_run, payload_rows
    from geobench.reference.placement import PlacementParams, place
    from geobench.reference.replay import Replay
    from geobench.reference.route import Router
    from geobench.traffic import make_reads, make_writes, warmup_reads

    config, mix = cell.config, cell.mix
    inputs = make_inputs(config, seed)
    g, env, pats = inputs.g, inputs.env, inputs.patterns
    eligible = np.array([i for i, p in enumerate(pats) if len(p.items)], np.int64)
    home = np.array([int(np.argmax(p.r_py)) for p in pats], np.int64)
    n_warm = sum(int(s) for s in mix["warmup_drains"])
    w_pat, w_org = warmup_reads(mix["reads"], eligible, home, env.n_dcs, seed, n_warm)
    stream = make_reads(mix["reads"], eligible, home, env.n_dcs, seed, seconds)
    pattern = np.concatenate([w_pat, stream.pattern])
    origin = np.concatenate([w_org, stream.origin])
    N = len(pattern)
    writes = mix.get("writes")
    batches = [] if writes is None else make_writes(
        writes, config["graph"], g, inputs.wiring, env.n_dcs, seed, seconds)
    # the warm-up's batches come before every read; a window read is sent
    # after every batch due by then
    dues = np.array([b.due for b in batches])
    due = np.concatenate([np.full(n_warm, 0.0), stream.due])
    version = np.searchsorted(dues, due, side="right") if batches else np.zeros(N, np.int64)
    delta = place(g, env, pats, PlacementParams(**config.get("placement", {}),
                                                round_step=to_bfloat16))
    state = Replay(g, delta, pats, env.rtt_s)  # the control's store
    router = Router(state.sizes(), env.rtt_s, env.bw_Bps, state.comp(), np.float32)
    router.set_replicas(state.delta)
    log = RunLog(pattern=pattern, origin=origin, drains=[], kept={},
                 latency_eq1=np.full(N, np.nan), answered=np.ones(N, bool),
                 batches=batches, version=version if batches else None,
                 drain_epoch=[] if batches else None)
    drain_rng = np.random.default_rng([seed, 3])
    batch = int(config["admission"]["max_batch"])
    sharded = config["store"]["kind"] == "sharded"
    starts = np.flatnonzero(np.diff(version, prepend=-1)).tolist() + [N]
    for lo_v, hi_v in zip(starts[:-1], starts[1:]):
        epoch = int(version[lo_v])
        while state.epoch < epoch:
            state.apply(batches[state.epoch])
            router.set_replicas(state.delta, state.sizes(), state.comp())
        for a in range(lo_v, hi_v, batch):
            ids = np.arange(a, min(a + batch, hi_v))
            org = origin[ids].tolist()
            answers = [router.route_items((int(pattern[i]), o, lo),
                                          lambda i=i: state.items_at(int(pattern[i]), epoch),
                                          o, lo)
                       for i, o, lo in zip(ids.tolist(), org, _lone(org, sharded))]
            log.latency_eq1[ids] = [r[3] for r in answers]
            if drain_rng.random() < SAMPLE_SHARE:
                log.kept[len(log.drains)] = [(int(i), r[0], r[1], r[2])
                                             for i, r in zip(ids.tolist(), answers)]
            if batches:
                log.drain_epoch.append(epoch)
            log.drains.append(ids)
    while state.epoch < len(batches):
        state.apply(batches[state.epoch])
    log.delta = state.delta
    if batches:
        log.graph = (state.n, state.src, state.dst, state.node_size, state.edge_size,
                     state.partition, state.uid)
    if sharded:
        n_shards = config["store"]["n_shards"]
        base = payload_rows(state.uid, config["store"]["payload_width"])
        log.payload = [base * state.delta[:, [d for d in range(env.n_dcs) if d % n_shards == s]]
                       .any(axis=1)[:, None] for s in range(n_shards)]
    checks = check_run(config, inputs, log)
    return all(v <= lim for _, v, lim in checks), checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from geobench.harness import resolve_cell

    cell = resolve_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        correct, checks = control_run(cell, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
