"""Find a configuration's knee: the highest open-loop read rate it sustains.

    python3 geobench/sweep.py --config snb-sf3-5shard --seed <n> --rates 5000,6500,...

Builds the configuration's store once on the card, then for each offered
rate drives a fresh admission controller with Poisson reads (the mix of
``--traffic``) for ``--seconds`` seconds, the clients keeping at most the
mix's ``max_outstanding`` reads in the store as in a run.  A rate passes
the backlog test when the mean count of reads due and not served over the
window's last second exceeds that over its first second by no more than
one ``max_batch``.  The knee is the highest
rate that passes; the table goes to standard output and to ``--out``.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def sweep_rate(store, config, items, stream, seconds: float, cap: int) -> dict:
    from repro_torch.serve.scheduler import AdmissionConfig, AdmissionController

    from geobench import stats
    from geobench.clock import WallClock

    clock = WallClock()
    ctl = AdmissionController(store, AdmissionConfig(**config["admission"]), clock=clock)
    T0 = clock.now()
    due = T0 + stream.due
    end = T0 + seconds
    clock.horizon = end
    t_ret = np.full(len(due), np.nan)
    samples = []  # (clock time, pending)
    i, N = 0, len(due)
    while True:
        now = clock.now()
        if now >= end:
            break
        while i < N and due[i] <= now and ctl.pending < cap:
            ctl.submit(items[stream.pattern[i]], int(stream.origin[i]), at=float(due[i]))
            i += 1
        if i < N and ctl.n_scheduled == 0 and ctl.pending < cap:
            ctl.submit(items[stream.pattern[i]], int(stream.origin[i]), at=float(due[i]))
            i += 1
        batch = ctl.step()
        t = clock.now()
        if batch:
            t_ret[[h.rid for h in batch]] = t
        samples.append((t - T0, ctl.pending + int(np.searchsorted(due, t, "right")) - i))
    s = np.asarray(samples)
    first = s[s[:, 0] < 1.0, 1].mean()
    last = s[s[:, 0] >= seconds - 1.0, 1].mean()
    in_w = due < end
    lat = stats.read_latencies(due[in_w], t_ret[in_w], np.zeros(int(in_w.sum()), bool), end)
    # drain what is left so the next rate starts from an empty queue
    clock.horizon = float("inf")
    while (i < N and due[i] < end) or ctl.pending or ctl.n_scheduled:
        while i < N and due[i] < end and ctl.pending < cap:
            ctl.submit(items[stream.pattern[i]], int(stream.origin[i]), at=float(due[i]))
            i += 1
        ctl.step()
    return {
        "pending_first_s": float(first), "pending_last_s": float(last),
        "passes": bool(last - first <= config["admission"]["max_batch"]),
        "completed_rps": float(np.sum(t_ret[in_w] <= end) / seconds),
        "p95_ms": stats.p95(lat) * 1e3,
        "drains": ctl.metrics()["n_batches"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="snb3s-read-over")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True, help="comma-separated reads/s")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from geobench.harness import build_store
    from geobench.inputs import make_inputs
    from geobench.traffic import load_mix, make_reads

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    config = json.loads((ROOT / "geobench" / "configs" / f"{args.config}.json").read_text())
    mix = load_mix(args.traffic)
    inputs = make_inputs(config, args.seed)
    pats = inputs.patterns
    eligible = np.array([i for i, p in enumerate(pats) if len(p.items)], np.int64)
    home = np.array([int(np.argmax(p.r_py)) for p in pats], np.int64)
    items = [p.items for p in pats]
    store = build_store(config, inputs, "cuda")
    # warm the batch path once; then, as in a run, set-up's objects go to
    # the collector's permanent generation
    store.serve_batch([(items[p], int(home[p])) for p in eligible[:256].tolist()])
    gc.collect()
    gc.freeze()
    print(f"built in {time.perf_counter() - T_PROCESS:.1f} s", flush=True)
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        reads = dict(mix["reads"], rate_rps=rate)
        stream = make_reads(reads, eligible, home, inputs.env.n_dcs, args.seed, args.seconds)
        row = {"offered_rps": rate, **sweep_rate(store, config, items, stream, args.seconds,
                                                 int(mix["max_outstanding"]))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    passing = [r["offered_rps"] for r in rows if r["passes"]]
    knee = max(passing) if passing else None
    print(f"knee of {args.config}: {knee} reads/s", flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps({"config": args.config, "rows": rows,
                                                       "knee_rps": knee}, indent=1))
    if getattr(store, "_pool", None) is not None:
        store._pool.shutdown(wait=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
