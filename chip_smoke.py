#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the GeoLayer store once on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run with a nonzero exit:

1. Device: CUDA must be present; prints the card's name and power limit.
2. Build: compiles ``src/repro_torch/csrc/*.cu`` with ``nvcc`` (sm_90a) and
   prints each kernel's registers, spill bytes and ptxas warnings.
3. Main path at full size, with every kernel's launch count set to 0 just
   before and read just after: a 530,175-item store (community graph of
   26,000 vertices, the paper's five-DC environment, 160 five-hop patterns,
   ``PlacementConfig()`` defaults) is built on the card, serves batches of
   64, 256 and 1024 requests, and runs ``maintain()``.  Every batch must be
   request-identical to the numpy router, and every kernel of that path
   (batched DHD count + flow, route expansion) must have run.
4. Kernels against their plain PyTorch versions on the card: route
   expansion on the store's own batches and on ``SWEEP`` (31 DCs, all-tie
   rows, rows with no items, and K at each instance's boundary: 32, 33, 64,
   65, 128, 129, 256, 257 and past 1,024, where each warp stages its slots
   in shared memory), with ``slots_instance`` printed for each timed case
   and checked against the kernel's own choice; DHD on the inputs of the 8th step (or the last) of each kind the
   main path ran (placement arenas with per-field vals, pre-caching,
   ``maintain``), recorded during phase 3, on two seeded shapes the lane
   lacks (7 fields, kmax 150; 6 fields with per-field vals), and on a
   sweep of the batched count's branches (``DHD_SWEEP``: heat on 4 levels,
   pad rows, B 1/5/7/6, kmax 71/80/150/37, n 10,007 and 3): counts and
   other integer outputs exact, DHD floats within atol 1e-5 / rtol 1e-4.
5. Streaming updates on the same store, counts set to 0 just before and
   read just after: two churn batches at rate 0.01 (global warm-DHD sweeps)
   and two at 2e-5 (a trickle whose frontier takes the pre-solve), each
   also applied to a CPU mirror of the store; then a migration flush on
   both, and on the card ``maintain()``, ``compact()`` and a served batch of
   1024 requests.  Report integers, replica sets and routes must equal the
   mirror's, heat within atol 1e-5 / rtol 1e-4; the served batch must be
   request-identical to the numpy router; at least one batch must take the
   pre-solve and both single-field DHD kernels must have run.  Flush plans
   may differ from the mirror's on heat near-ties: counted, not failed.
6. The single-field DHD kernels against their plain versions on the card,
   on the inputs of real sweeps recorded in phase 5 (global and pre-solve),
   and on a sweep of the flow pass's instances (``DHD_SINGLE_SWEEP``: 8, 16
   and 32 lanes a row, 16-byte or scalar loads, a misaligned base, kmax up
   to 400), with tie-heavy heat and pad rows.
7. A CPU build of the same store: replica rows that differ from the card's.
   The store is freed after this phase.
8. LM serving at full width, counts set to 0 just before and read just
   after: ``deepseek-v2-lite-16b`` (MLA + MoE, 16 B parameters, bf16,
   random weights drawn on the card from seed 0) behind the
   continuous-batching ``Engine`` (4 slots, 1,024 positions) serves 8
   requests of 64-700 prompt tokens, 16 new tokens each.  Every request must
   complete with 16 tokens and finite logits, and every prefill must run the
   flash-attention kernel in each of its 27 layers.  Prints init seconds,
   prefill and decode-step times, tokens/s, peak memory, and one prefill and
   one decode step under the profiler.
9. End to end: the prefill with the kernel against the same prefill with
   ``kernels.ops.attention`` swapped for its plain version, on a 2-layer
   model at full width in f32 (within atol/rtol 1e-3), and reported (not
   failed) on the full-depth bf16 model beside two controls (SDPA, and the
   f32 kernel on upcast inputs), each with its layer-0 outputs' count of
   differences from the plain version and RMS distance to f64.
10. The flash-attention kernel against its plain version on the card on
    layer 0's q, k, v recorded from the longest and the shortest prefill:
    bf16 within 2e-2, the same inputs in f32 within 2e-5; timed in turns
    with ``scaled_dot_product_attention`` beside its bound.  Then a sweep of shapes the
    LM path never gives it (GQA, a window, suffix-aligned and fully masked
    rows, widths 16-256, lengths 1-1,024, a transposed v, two batch rows),
    each in bf16 and f32 within the same tolerances; fully masked rows must
    be exactly 0, and a bf16 view the kernel cannot copy must raise.
11. Embedding bags, counts set to 0 just before and read just after: BST's
    item table (2^22 x 32, f32) and Zipf ids, 20 a bag, at batches of 512
    and 262,144, weighted, in sum and mean, through
    ``models.recsys.embedding.bag_lookup``: within 1e-4 of the plain
    version; timed beside the bound and ``F.embedding_bag``, with the
    instance that ran (``embedding_bag.instance``).  Then ``BAG_SWEEP``
    within 1e-4: f32 and bf16, D 16-256 and 33 (one element a load), L 0-64,
    a partial last block, no weights, zero weights in mean, a misaligned
    table view.

12. Competitor stores at full size (paper Figs. 7 and 16) on the lane's
    inputs, with 40 held-out test patterns drawn as
    ``benchmarks/common.py:50-69`` draws them: GeoLayer, then Random-3 and
    Top-3 with random routing, ADP and DCD with greedy set-cover routing,
    and LP+RR (GeoLayer's placement, random routing), each built on the
    card, with its build seconds and its mean modelled online latency (65%
    home origins) normalised to GeoLayer's.  Then RP+SR
    (random placement, stepwise routing), counts set to 0 just before and
    read just after its build, batches of 64, 256 and 1024 requests and
    ``maintain()``: every batch request-identical to the numpy router and
    to a CPU mirror, replica sets and routes after ``maintain()`` equal to
    the mirror's, ``route_expand`` and both batched DHD kernels launched;
    both held against their plain versions on RP+SR's own inputs (phase 4's
    tolerances), with ``slots_instance`` printed for its tiles.
13. Offline routing and layouts at full size (Figs. 13-15): ``plan_offline``
    over all 26,000 vertices of the phase-12 GeoLayer store, the
    consolidated-or-in-place choice of ``bench_offline.py:27-55``, and the
    RAGraph, RAGraph+ and GrapH layouts; the plan's fields and every layout
    must equal a CPU mirror's.  Each layout is priced by the BSP model for
    PageRank (15 supersteps), SSSP (10), HITS (20), LPA (10) and k-core
    (its peel rounds): time, WAN bytes, speedup against RAGraph.
14. Graph analytics on the card: PageRank (15 iterations), SSSP (10,
    weights ``edge_size``, source 0), HITS (20) and LPA (10) on the lane
    graph (26,000 vertices, 504,175 edges; k-core on the host beside them)
    and on ``rmat_graph(20, edge_factor=16, a=0.57, b=0.19, c=0.19)``
    (1,048,576 vertices, about 16.1 M edges), each against the same
    function run on the host: SSSP and LPA equal, PageRank and HITS within
    rtol 1e-4 / atol 1e-7.  Prints ms an iteration (CUDA events around the
    whole call after a warm-up), edges a second, the byte bound of an
    iteration and the device's busy share under the profiler.

Kernel times (``ms``, and ``library_ms`` for the PyTorch calls beside them)
come from CUDA-graph replay: 20 launches captured in one graph, replayed
between two CUDA events, so the host's launch rate does not set them; the
old host-loop figure stands beside each as ``host_loop_ms``, and
``launch_floor_ms`` is the replayed time of a launch that does no work.
``flash_attention`` and SDPA are replayed in turns within one call.

Prints the kernel table as one JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import gc
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
DHD_TOL = dict(atol=1e-5, rtol=1e-4)
BATCHES = (64, 256, 1024)
# (rate, batches): bench_streaming's churn rate, then a trickle of single
# edits whose touched frontier stays under the pre-solve's 20% gate
CHURN = ((0.01, 2), (2e-5, 2))
# the kernels slice A's path (build, serve, maintain) launches
MAIN_KERNELS = ("dhd_count", "dhd_flow", "route_expand")
SINGLE_KERNELS = ("dhd_count_single", "dhd_flow_single")
DEVICE = "cuda"  # the card every phase runs on
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
# LM serving: the repo's MLA + MoE arch at full width, its engine's slots
LM_ARCH = "deepseek-v2-lite-16b"
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW = 4, 1024, 8, 16
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# phase 10's sweep: name, B, Hq, Hkv, Sq, Skv, Dqk, Dv, causal, window, v transposed
ATTN_SWEEP = (
    ("GQA 8/2", 1, 8, 2, 256, 256, 64, 64, True, None, False),
    ("window 128", 1, 4, 4, 605, 605, 128, 128, True, 128, False),
    ("suffix-aligned Sq < Skv", 1, 4, 4, 100, 300, 64, 64, True, None, False),
    ("one query of 1,024 keys", 1, 4, 4, 1, 1024, 192, 128, True, None, True),
    ("causal Sq > Skv", 1, 4, 4, 300, 100, 64, 64, True, None, False),
    ("not causal", 1, 4, 4, 200, 150, 64, 64, False, None, False),
    ("widths 24/16", 1, 4, 4, 128, 128, 24, 16, True, None, False),
    ("widths 64/64", 1, 4, 4, 128, 128, 64, 64, True, None, False),
    ("widths 128/128", 1, 4, 4, 128, 128, 128, 128, True, None, False),
    ("widths 256/256", 1, 4, 4, 128, 128, 256, 256, True, None, False),
    ("widths 64/256", 1, 4, 4, 128, 128, 64, 256, True, None, False),
    ("widths 192/128", 1, 4, 4, 128, 128, 192, 128, True, None, False),
    ("length 1", 1, 16, 16, 1, 1, 192, 128, True, None, True),
    ("length 63", 1, 16, 16, 63, 63, 192, 128, True, None, True),
    ("length 65", 1, 16, 16, 65, 65, 192, 128, True, None, True),
    ("length 605", 1, 16, 16, 605, 605, 192, 128, True, None, True),
    ("length 1,024", 1, 16, 16, 1024, 1024, 192, 128, True, None, True),
    ("window 128, length 1,024", 1, 16, 16, 1024, 1024, 192, 128, True, 128, True),
    ("batch 2, GQA 4/2", 2, 4, 2, 130, 130, 64, 64, True, None, False),
)
E2E_TOL = dict(atol=1e-3, rtol=1e-3)
# BST's item table (configs/bst.py) and the serving batches of RECSYS_SHAPES
BAG_V, BAG_D, BAG_L = 1 << 22, 32, 20
BAG_BATCHES = (512, 262_144)
BAG_TOL = dict(atol=1e-4, rtol=1e-4)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_query(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def gpu_line() -> str:
    return gpu_query("name,power.limit")


def host_loop_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean time of ``fn`` in ms over ``iters`` calls issued by Python
    between two CUDA events.  Where one call takes the host longer to issue
    than the card to run, this reads the host's launch interval."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _capture(fn, warmup: int, iters: int):
    """``iters`` calls of ``fn`` in one CUDA graph, after ``warmup`` calls
    on a side stream.  ``fn`` must read the current stream when it
    launches, so that its launches land on the capturing stream."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(graph, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_in_turns(fns, warmup: int = 3, iters: int = 20, reps: int = 7) -> list:
    """Device time in ms of one call of each of ``fns``: each function's
    ``iters`` calls are captured in one CUDA graph, the graphs are replayed
    in turns ``reps`` times between two events each, and each time is the
    median replay over ``iters``.  The host issues one replay for
    ``iters`` launches, so its launch rate does not set the figure."""
    import numpy as np

    graphs = [_capture(fn, warmup, iters) for fn in fns]
    times = [[] for _ in fns]
    for _ in range(reps):
        for graph, t in zip(graphs, times):
            t.append(_replay_ms(graph, iters))
    del graphs
    return [float(np.median(t)) for t in times]


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Device time in ms of one call of ``fn``, by CUDA-graph replay."""
    return cuda_ms_in_turns([fn], warmup, iters)[0]


def kernel_ms(fn) -> dict:
    """A kernel launch's graph-replayed time (``ms``) and the old host-loop
    figure beside it (``host_loop_ms``)."""
    return {"ms": cuda_ms(fn), "host_loop_ms": host_loop_ms(fn)}


def launch_floor_ms() -> float:
    """Graph-replayed time of a launch that does no work: the batched count
    kernel on a 1-row graph with one pad slot."""
    import torch

    from repro_torch.kernels.cuda_lib import library, stream_ptr

    lib = library().get()
    heat = torch.zeros((1, 1), device=DEVICE)
    cols = torch.zeros((1, 1), dtype=torch.int32, device=DEVICE)
    vals = torch.zeros((1, 1), device=DEVICE)
    nout = torch.empty_like(heat)
    return cuda_ms(lambda: lib.dhd_count_batch(
        heat.data_ptr(), cols.data_ptr(), vals.data_ptr(), nout.data_ptr(), 1, 1, 1, 0,
        stream_ptr(heat.device)))


def request_stream(store, n: int, seed: int):
    """Sampled pattern requests with a 65% home / 35% remote origin mix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pats = [p for p in store.workload.patterns if len(p.items)]
    reqs = []
    for _ in range(n):
        p = pats[int(rng.integers(0, len(pats)))]
        home = int(np.argmax(p.r_py))
        origin = home if rng.random() < 0.65 else int(rng.integers(0, store.env.n_dcs))
        reqs.append((p.items, origin))
    return reqs


def same_results(got, want) -> bool:
    import numpy as np

    return len(got) == len(want) and all(
        np.array_equal(x.served_by, y.served_by)
        and x.latency_s == y.latency_s
        and x.per_dc_latency == y.per_dc_latency
        for x, y in zip(got, want)
    )


def launch_counts() -> dict:
    """Every kernel's launch count so far, by name."""
    from repro_torch.kernels.cuda_lib import launch_counters

    return {k: c.n for k, c in launch_counters().items()}


def build_inputs():
    from repro_torch.core.graph import build_csr
    from repro_torch.core.latency import make_paper_env
    from repro_torch.core.patterns import Workload, generate_khop_patterns
    from repro_torch.data.synthetic import community_graph

    g = community_graph(26_000, n_communities=20, p_in=0.02, p_out=0.0005, seed=0, n_dcs=5)
    env = make_paper_env()
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = generate_khop_patterns(
        g, csr, 160, hops=5, branch=2, seed=1, n_dcs=env.n_dcs, n_hot_sources=64
    )
    return g, env, Workload.from_patterns(pats, g.n_items, env.n_dcs)


class DHDRecorder:
    """Keeps the inputs of the main path's DHD steps, one call per kind.

    Installed over ``kernels.ops.dhd_ell_step_batch`` (the name
    ``diffuse_batch`` calls) for the main path's run, it passes every call
    on unchanged and keeps, for each (phase, fields, shared or per-field
    vals), the tensors of its ``KEEP_AT``-th call, or of its last when the
    loop is shorter.  The step loop never writes into its inputs, so
    references suffice.

    ``KEEP_AT`` is 8 because the placement arenas' fields diverge, in the
    JAX package as here: their super-node weights (graph-edge counts, up to
    636 on this store) break Theorem 1's bound, the heat grows about 300x a
    step and overflows f32 after about 17 of its 32 steps.  A check of 4
    chained steps from call 8 stays finite."""

    KEEP_AT = 8
    ATTR = "dhd_ell_step_batch"

    def __init__(self, ops) -> None:
        self.ops = ops
        self.step = getattr(ops, self.ATTR)
        self.phase = "build"
        self.calls: dict = {}
        self.kept: dict = {}
        self.by_shape: dict = {}  # (phase, [B,] n, kmax, per-field vals) -> calls

    def key(self, heat, cols, vals) -> tuple:
        return (self.phase, int(heat.shape[0]), vals.dim() == 3)

    def keep(self, heat, cols, vals, q) -> tuple:
        return heat, cols, vals, q

    def __call__(self, heat, cols, vals, q, alpha=0.5, gamma=0.1, beta=0.3):
        key = self.key(heat, cols, vals)
        n = self.calls[key] = self.calls.get(key, 0) + 1
        shape = (self.phase, *heat.shape, int(cols.shape[1]), vals.dim() == 3)
        self.by_shape[shape] = self.by_shape.get(shape, 0) + 1
        if n <= self.KEEP_AT:
            self.kept[key] = (*self.keep(heat, cols, vals, q), (alpha, gamma, beta))
        return self.step(heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta)

    def __enter__(self) -> "DHDRecorder":
        setattr(self.ops, self.ATTR, self)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self.ops, self.ATTR, self.step)


class SweepRecorder(DHDRecorder):
    """The same over ``kernels.ops.dhd_ell_step`` (one heat field: the warm
    DHD sweeps of ``store``'s ``StreamingHeat``), keyed by (phase, global
    or pre-solve sweep, rows): a global sweep runs over the field's own
    device adjacency, a pre-solve sweep over a sub-ELL of the frontier.  It
    keeps copies of ``cols`` and ``vals``: a later batch patches the
    field's device adjacency in place (``index_copy_``)."""

    ATTR = "dhd_ell_step"

    def __init__(self, ops, store) -> None:
        super().__init__(ops)
        self.store = store

    def key(self, heat, cols, vals) -> tuple:
        sweep = "global" if cols is self.store._heat._cols_j else "pre-solve"
        return (self.phase, sweep, int(heat.shape[0]))

    def __call__(self, heat, cols, vals, q, alpha=0.5, gamma=0.1, beta=0.3):
        if heat.device.type != self.store.device.type:  # the host mirror's sweeps
            return self.step(heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta)
        return super().__call__(heat, cols, vals, q, alpha=alpha, gamma=gamma, beta=beta)

    def keep(self, heat, cols, vals, q) -> tuple:
        return heat, cols.clone(), vals.clone(), q


def main_path(report: dict):
    """Phase 3: build, serve and maintain on the card, with the DHD steps'
    inputs recorded; returns the store, the inputs, the built replica sets,
    the launch counts and the recorder."""
    from repro_torch.kernels import ops

    inputs = build_inputs()
    with DHDRecorder(ops) as rec:
        return (*_drive_main_path(report, inputs, rec), rec)


def _drive_main_path(report: dict, inputs, rec: DHDRecorder):
    import numpy as np
    import torch

    from repro_torch.core.placement import PlacementConfig
    from repro_torch.core.routing import route_online_batch
    from repro_torch.core.store import GeoGraphStore
    from repro_torch.kernels.cuda_lib import reset_launch_counters

    counts = launch_counts
    g, env, wl = inputs
    reset_launch_counters()
    t0 = time.perf_counter()
    store = GeoGraphStore(g, env, wl, config=PlacementConfig(), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built_delta = store.state.delta.copy()  # maintain() evicts from it later
    launches = {"build": counts()}
    print(f"store: {store.g.n_items} items, {store.lg.n_layers} layers, "
          f"built on the card in {build_s:.3f} s", flush=True)
    serve = []
    for bs in BATCHES:
        reqs = request_stream(store, bs, seed=bs)
        before = counts()
        got = store.serve_batch(reqs, observe=False)
        launches[f"serve_{bs}"] = {k: v - before[k] for k, v in counts().items()}
        want = route_online_batch(store.lg, store.state, reqs, fast=False)
        if not same_results(got, want):
            fail(f"serve_batch({bs}) on the card differs from the numpy router")
        times, numpy_times = [], []
        for _ in range(5):
            t = time.perf_counter()
            store.serve_batch(reqs, observe=False)
            times.append(time.perf_counter() - t)
            t = time.perf_counter()
            route_online_batch(store.lg, store.state, reqs, fast=False)
            numpy_times.append(time.perf_counter() - t)
        med = float(np.median(times))
        med_np = float(np.median(numpy_times))
        store.serve_batch(reqs, observe=True)  # deposit the batch's heat once
        items = int(sum(len(it) for it, _ in reqs))
        serve.append({"batch": bs, "items": items, "median_s": med, "rps": bs / med,
                      "times_s": times, "numpy_median_s": med_np,
                      "numpy_rps": bs / med_np})
        print(f"serve_batch({bs}): {items} items, median {med * 1e3:.3f} ms, "
              f"{bs / med:.1f} routed requests/s, identical to the numpy router "
              f"(numpy router alone: {med_np * 1e3:.3f} ms, {bs / med_np:.1f}/s)",
              flush=True)
    before = counts()
    rec.phase = "maintain"
    t = time.perf_counter()
    m = store.maintain()
    torch.cuda.synchronize()
    maintain_s = time.perf_counter() - t
    launches["maintain"] = {k: v - before[k] for k, v in counts().items()}
    total = counts()
    print(f"maintain: evicted {m['evicted']} replicas in {maintain_s:.3f} s", flush=True)
    print(f"launches on the main path: {total} (per phase: {launches})", flush=True)
    by_shape = {", ".join(map(str, k)): v for k, v in sorted(rec.by_shape.items())}
    print(f"batched DHD steps (one count + one flow launch each) by phase, B, n, kmax, "
          f"per-field vals: {by_shape}", flush=True)
    for name in MAIN_KERNELS:
        if total[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    report["main_path"] = {
        "n_items": int(store.g.n_items), "n_layers": int(store.lg.n_layers),
        "build_s": build_s, "serve": serve, "maintain_s": maintain_s,
        "evicted": int(m["evicted"]), "launches": total, "launches_by_phase": launches,
        "dhd_steps_by_shape": by_shape,
    }
    return store, inputs, built_delta, total


def profiled(fn, reps: int = 1, host: dict = None):
    """``(wall ms, device busy ms, device ms by kernel or copy, fn's last
    result)`` per call of ``fn`` over ``reps`` calls under the profiler;
    ``host``, when given, receives the 8 host ops of most self CPU ms.

    Only the profiler's device events count: a kernel launched by an aten
    op also appears as that CPU op's self device time, and summing both
    would count it twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    busy_us = 0.0
    by_kind = {}
    events = prof.key_averages()
    if host is not None:
        cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:8]:
            host[e.key[:60]] = {"self_cpu_ms": e.self_cpu_time_total / reps / 1e3,
                                "calls": e.count // reps}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us:
            busy_us += us
            by_kind[e.key[:60]] = us / reps / 1e3
    return wall_ms, busy_us / reps / 1e3, by_kind, out


def device_busy(store, report: dict) -> None:
    """Device time per call of serve_batch(1024) and maintain(), from the
    profiler's CUDA events (kernels and copies), beside the host clock."""
    import torch

    reqs = request_stream(store, BATCHES[-1], seed=BATCHES[-1])
    out = {}
    for name, fn, reps in (
        ("serve_batch_1024", lambda: store.serve_batch(reqs, observe=False), 5),
        ("maintain_no_evict", lambda: store.maintain(evict=False), 2),
    ):
        fn()
        torch.cuda.synchronize()
        wall_ms, busy_ms, by_kind, _ = profiled(fn, reps)
        out[name] = {"device_ms": busy_ms, "wall_ms_profiled": wall_ms,
                     "device_share": busy_ms / wall_ms, "by_kind_ms": by_kind}
        print(f"{name}: device busy {busy_ms:.4f} ms of {wall_ms:.3f} ms "
              f"(profiled wall), share {busy_ms / wall_ms:.4f}; "
              + ", ".join(f"{k.strip()} {v:.4f}" for k, v in by_kind.items()), flush=True)
    report["device_busy"] = out


def rand_route_problem(rng, R, k_lo, k_hi, D, L, p_rep=0.35, all_ties=False,
                       single_origin=False, empty_layers=False, pin_max=False,
                       empty_rows=False):
    """A random packed batch; ``pin_max`` makes row 0 ``k_hi`` long (so K is
    exactly ``k_hi``), ``empty_rows`` gives every third row no items."""
    import numpy as np

    lens = rng.integers(k_lo, k_hi + 1, R)
    if pin_max:
        lens[0] = k_hi
    if empty_rows:
        lens[1::3] = 0
    K = int(lens.max())
    bits = np.zeros((R, K), np.int32)
    sizes = np.zeros((R, K), np.float32)
    pow2 = 1 << np.arange(D, dtype=np.int64)
    for r in range(R):
        k = int(lens[r])
        rep = np.ones((k, D), bool) if all_ties else rng.random((k, D)) < p_rep
        bits[r, :k] = (rep * pow2).sum(axis=1)
        sizes[r, :k] = (rng.random(k) + 0.25).astype(np.float32)
    origin = np.zeros(R, np.int64) if single_origin else rng.integers(0, D, R)
    comp = np.zeros((L + 1, D), np.int64)
    comp[0] = np.arange(D)
    prev = np.arange(D)
    for layer in range(1, L + 1):
        if empty_layers and layer == 1:
            comp[layer] = prev
            continue
        groups = max(1, D // (layer + 1))
        prev = rng.integers(0, groups, int(prev.max()) + 1)[prev]
        comp[layer] = prev
    rtt = rng.random((D, D)).astype(np.float32) * 0.2
    rtt = rtt + rtt.T
    np.fill_diagonal(rtt, 0.0)
    ibw = (1.0 / (rng.random((D, D)) * 1e9 + 1e8)).astype(np.float32)
    np.fill_diagonal(ibw, 0.0)
    return (bits, sizes, lens.astype(np.int32), origin.astype(np.int32),
            comp.astype(np.int32), rtt, ibw)


SWEEP_FLAGS = ("all_ties", "single_origin", "empty_layers", "pin_max", "empty_rows")
SWEEP = [
    # R, k_lo, k_hi, D, L, p_rep, then SWEEP_FLAGS (False where left out)
    (8, 1, 24, 5, 3, 0.35, False, False, False),
    (16, 2, 40, 4, 1, 0.5, False, False, False),
    (8, 1, 16, 8, 5, 0.2, False, False, False),
    (8, 4, 20, 5, 3, 0.0, True, False, False),
    (8, 1, 24, 5, 3, 0.35, False, True, False),
    (8, 1, 24, 6, 4, 0.3, False, False, True),
    (4, 1, 8, 5, 2, 0.05, False, False, False),
    (4, 496, 500, 5, 3, 0.35, False, False, False),
    (4, 596, 600, 5, 3, 0.35, False, False, False),
    (256, 1, 160, 31, 4, 0.1, False, False, False),  # 31 DCs: every mask bit
    # the instances' boundaries (slots a lane 1 | 2 | 4 | 8 | shared memory)
    (16, 1, 32, 5, 3, 0.35, False, False, False, True),
    (16, 1, 33, 5, 3, 0.35, False, False, False, True),
    (16, 1, 64, 5, 3, 0.35, False, False, False, True),
    (16, 1, 65, 5, 3, 0.35, False, False, False, True),
    (16, 1, 128, 6, 4, 0.3, False, False, False, True),
    (16, 1, 129, 6, 4, 0.3, False, False, False, True),
    (64, 1, 256, 5, 3, 0.35, False, False, False, True),
    (64, 1, 257, 5, 3, 0.35, False, False, False, True),
    (64, 200, 256, 31, 4, 0.1, False, False, False, True),
    (64, 200, 257, 31, 4, 0.1, False, False, False, True),
    (8, 1000, 1100, 5, 3, 0.35, False, False, False, True),  # past 1,024 slots
    (8, 256, 256, 5, 3, 0.0, True, False, False, True),  # all ties at 8 slots a lane
    # rows with no items, in a register and a shared-memory instance
    (24, 1, 40, 5, 3, 0.35, False, False, False, True, True),
    (24, 1, 300, 5, 3, 0.35, False, False, False, True, True),
]


def check_route_expand(name, prob, timed: bool) -> dict:
    """Kernel vs plain version on the card; integer outputs must be equal."""
    import numpy as np
    import torch

    from repro_torch.kernels.ref import route_expand_ref
    from repro_torch.kernels.route_expand import route_expand

    args = tuple(torch.as_tensor(np.ascontiguousarray(x), device="cuda") for x in prob)
    got = route_expand(*args)
    want = route_expand_ref(*args)
    torch.cuda.synchronize()
    for i, label in ((0, "served"), (2, "layers_used"), (3, "miss_after")):
        if not torch.equal(got[i], want[i]):
            fail(f"route_expand {name}: {label} differs from the plain version")
    err = 0.0
    for i, (rtol, atol) in ((1, (1e-5, 1e-4)), (4, (1e-5, 1e-7)), (5, (1e-5, 1e-4))):
        if not torch.allclose(got[i], want[i], rtol=rtol, atol=atol):
            fail(f"route_expand {name}: output {i} outside rtol {rtol} / atol {atol}")
        err = max(err, float((got[i] - want[i]).abs().max()))
    from repro_torch.kernels.cuda_lib import library, stream_ptr
    from repro_torch.kernels.route_expand import slots_instance

    R, K = prob[0].shape
    lib = library().get()
    instance = slots_instance(K)
    if lib.route_expand_slots(K) != instance:
        fail(f"route_expand {name}: the kernel runs {lib.route_expand_slots(K)} slots a lane, "
             f"slots_instance says {instance}")
    out = {"case": name, "max_abs_err": err, "K": K, "slots_instance": instance}
    if timed:
        from repro_torch.kernels.route_expand import BLOCK_R

        bits, sizes, lens, origin, comp, rtt, ibw = prob
        D, L = comp.shape[1], comp.shape[0] - 1
        nbytes = (int(lens.sum()) * 8 + R * 8 + comp.size * 4 + 2 * D * D * 4
                  + R * K * 4 + R * (D + L + 1 + 3) * 4)
        ptrs = [a.data_ptr() for a in args] + [o.data_ptr() for o in got]

        # the C entry point straight, into the outputs above: the kernel's
        # own time, without the wrapper's checks and allocations
        def launch():
            lib.route_expand_launch(*ptrs, R, K, D, L, BLOCK_R, stream_ptr(args[0].device))

        out.update(
            shape=[R, K, D, L], items=int(lens.sum()), **kernel_ms(launch),
            wrapper_ms=host_loop_ms(lambda: route_expand(*args)),
            plain_ms=host_loop_ms(lambda: route_expand_ref(*args), warmup=1, iters=5),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        )
    return out


def check_dhd(name, heat, cols, vals, q, params, timed: bool = True) -> dict:
    """Count and flow kernels vs their plain versions on the card, one
    step from the same input at a time over 4 chained steps; ``params`` is
    the step's ``(alpha, gamma, beta)``.  Counts must be equal, flows
    within ``DHD_TOL``."""
    import torch

    from repro_torch.kernels.cuda_lib import library, stream_ptr
    from repro_torch.kernels.dhd_spmv import dhd_ell_step_batch
    from repro_torch.kernels.ref import (
        dhd_ell_count_ref,
        dhd_ell_flow_ref,
        dhd_ell_ref_batch,
    )

    lib = library().get()
    B, n = heat.shape
    kmax = cols.shape[1]
    per_field = int(vals.dim() == 3)
    alpha, gamma, beta = (float(x) for x in params)
    p = dict(alpha=alpha, gamma=gamma, beta=beta)
    nout = torch.empty_like(heat)
    out = torch.empty_like(heat)

    # the two C entry points straight, so each kernel is checked and timed
    # on its own (these launches are outside the main path's counts); the
    # stream is read at launch, so a graph capture takes the launches
    def count(h):
        lib.dhd_count_batch(h.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                            nout.data_ptr(), B, n, kmax, per_field, stream_ptr(h.device))

    def flow(h):
        lib.dhd_flow_batch(h.data_ptr(), nout.data_ptr(), cols.data_ptr(),
                           vals.data_ptr(), q.data_ptr(), out.data_ptr(), B, n, kmax,
                           per_field, alpha, 1.0 - gamma, beta, stream_ptr(h.device))

    err_count = err_flow = 0.0
    for _ in range(4):
        count(heat)
        want_n = dhd_ell_count_ref(heat, cols, vals)
        flow(heat)
        want = dhd_ell_flow_ref(heat, want_n, cols, vals, q, **p)
        step = dhd_ell_step_batch(heat, cols, vals, q, **p)
        full = dhd_ell_ref_batch(heat, cols, vals, q, **p)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(want).all()):
            fail(f"dhd {name}: the plain version overflowed; check an earlier step")
        if not torch.equal(nout, want_n):
            fail(f"dhd count kernel {name}: |N_out| differs from the plain version")
        for got in (out, step):
            if not torch.allclose(got, want, **DHD_TOL):
                fail(f"dhd flow kernel {name}: outside atol 1e-5 / rtol 1e-4")
        if not torch.allclose(step, full, **DHD_TOL):
            fail(f"dhd step {name}: outside atol 1e-5 / rtol 1e-4")
        err_count = max(err_count, float((nout - want_n).abs().max()))
        err_flow = max(err_flow, float((out - want).abs().max()))
        heat = want  # next step from the plain version's field
    row = {"case": name, "shape": [B, n, kmax], "per_field_vals": bool(per_field),
           "count": {"max_abs_err": err_count}, "flow": {"max_abs_err": err_flow}}
    if not timed:
        return row
    count(heat)
    vbytes = vals.numel() * 4
    cbytes = cols.numel() * 4
    field = B * n * 4
    count_bytes = field + cbytes + vbytes + field
    flow_bytes = 3 * field + cbytes + vbytes + field
    # what the passes gather: h[b, c] of every live slot and field (both
    # passes), nout[b, c] where heat flows in (the flow pass); how far a
    # live slot's column lies from its row
    live = (vals > 0).expand(B, n, kmax)
    inflow = live & (heat[:, cols.long()] > heat[:, :, None])
    rows = torch.arange(n, device=cols.device)[:, None]
    dist = (cols.long() - rows).abs()[(vals[0] if per_field else vals) > 0]
    row.update({
        "count_gathers": int(live.sum()),
        "flow_gathers": int(live.sum()) + int(inflow.sum()),
        "median_col_distance": float(dist.float().median()) if dist.numel() else 0.0,
    })
    row["count"].update(
        **kernel_ms(lambda: count(heat)),
        plain_ms=host_loop_ms(lambda: dhd_ell_count_ref(heat, cols, vals)),
        bytes=count_bytes, bound_ms=count_bytes / HBM_BYTES_PER_S * 1e3)
    row["flow"].update(
        **kernel_ms(lambda: flow(heat)),
        plain_ms=host_loop_ms(lambda: dhd_ell_flow_ref(heat, nout, cols, vals, q, **p)),
        bytes=flow_bytes, bound_ms=flow_bytes / HBM_BYTES_PER_S * 1e3)
    return row


def tie_problem(gen, B: int, n: int, kmax: int, per_field: bool, single: bool = False):
    """Seeded DHD inputs on the card where the new designs branch: heat on
    4 levels (h_u == h_c is frequent, so both strict masks are exercised),
    about 45% pad slots (weight 0, column = the row), every 17th row pad
    slots only, per-field vals with their own zero patterns."""
    import torch

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEVICE)

    rows = torch.arange(n, device=DEVICE, dtype=torch.int32)[:, None]
    cols = torch.randint(0, n, (n, kmax), generator=gen, device=DEVICE, dtype=torch.int32)
    pad = rand(n, kmax) < 0.45
    pad[::17] = True
    cols = torch.where(pad, rows, cols)
    shape = (B, n, kmax) if per_field else (n, kmax)
    vals = (rand(*shape) + 0.05) * ~pad
    if per_field:
        vals *= rand(*shape) < 0.8  # edges switched off per field
    heat = torch.floor(rand(B, n) * 4) / 4
    q = rand(B, n) * 0.1
    if single:
        return heat[0].contiguous(), cols, vals, q[0].contiguous()
    return heat, cols, vals, q


# the new designs' branches: B with FB 1 and 5 and none up to 5 (7), per-field
# vals in groups of 3 (6 fields); kmax 71 (3 sweeps of a warp), 80, 150 (past
# one sweep), 37 (not a multiple of 4); a prime n, which no block size
# divides, and rows fewer than the SMs
DHD_SWEEP = (
    # B, n, kmax, per-field vals
    (1, 10_007, 71, False),
    (5, 10_007, 80, False),
    (7, 10_007, 150, False),
    (6, 10_007, 37, True),
    (5, 10_007, 71, True),
    (1, 10_007, 150, True),
    (5, 3, 37, False),
)
# the single-field flow pass's instances: 8, 16 and 32 lanes a row, 16-byte
# loads (kmax % 4 == 0, aligned) or scalar ones, one sweep or two (kmax 400)
DHD_SINGLE_SWEEP = (
    # n, kmax, base 16-byte aligned
    (10_007, 80, True),
    (10_007, 80, False),
    (10_007, 71, True),
    (10_007, 150, True),
    (10_007, 37, True),
    (10_007, 32, True),
    (10_007, 400, True),
    (3, 80, True),
)


def ptxas_of(report: dict, prefix: str) -> str:
    return "; ".join(f"{k}: {v.get('registers')} registers, spill bytes {v.get('spill_bytes')}"
                     for k, v in sorted(report["ptxas"].items()) if k.startswith(prefix))


def dhd_sweep(report: dict) -> None:
    """Phase 4's sweep: the batched count and flow kernels against their
    plain versions on every ``DHD_SWEEP`` case (tie-heavy heat, pad rows)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rows = []
    for B, n, kmax, per_field in DHD_SWEEP:
        name = f"sweep: {B} fields, n {n}, kmax {kmax}, {'per-field' if per_field else 'shared'} vals"
        rows.append(check_dhd(name, *tie_problem(gen, B, n, kmax, per_field),
                              (0.5, 0.1, 0.3), timed=False))
    report["dhd_sweep"] = rows
    print(f"dhd sweep: {len(rows)} cases (B 1/5/7/6, kmax 71/80/150/37, n 10,007 and 3, "
          f"tie-heavy heat, pad rows): counts equal, flows within atol 1e-5 / rtol 1e-4, "
          f"max abs err {max(r['flow']['max_abs_err'] for r in rows):.3g}", flush=True)
    print(f"  ptxas: {ptxas_of(report, 'dhd_count_kernel')}", flush=True)


def kernel_checks(store, rec: DHDRecorder, report: dict) -> dict:
    """Phase 4; returns the kernel table rows by name.  The DHD kernels are
    checked on the inputs the main path gave them (``rec``)."""
    import numpy as np
    import torch

    from repro_torch.core.routing import pack_request_tiles

    routes = []
    for bs in BATCHES:
        prob = pack_request_tiles(store.lg, store.state, request_stream(store, bs, seed=bs))
        routes.append(check_route_expand(f"store batch {bs}", prob, timed=True))
        r = routes[-1]
        print(f"route_expand {r['case']} {r['shape']} (R, K, D, L; slots a lane "
              f"{r['slots_instance']}): exact, max abs err "
              f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms (host loop "
              f"{r['host_loop_ms']:.4f}, through the wrapper {r['wrapper_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms", flush=True)
    for i, case in enumerate(SWEEP):
        rng = np.random.default_rng(1000 + i)
        prob = rand_route_problem(rng, *case[:6], **dict(zip(SWEEP_FLAGS, case[6:])))
        routes.append(check_route_expand(f"sweep {case}", prob, timed=False))
    sweep = routes[len(BATCHES):]
    print(f"route_expand: {len(SWEEP)} sweep cases exact (31 DCs, K "
          f"{sorted({r['K'] for r in sweep})}, slots a lane "
          f"{sorted({r['slots_instance'] for r in sweep})} (0 = shared memory), rows with no "
          f"items)", flush=True)
    print(f"  ptxas: {ptxas_of(report, 'route_expand')}", flush=True)

    if not any(per_field for _, _, per_field in rec.kept):
        fail("the main path ran no DHD step with per-field vals (placement arena)")
    if ("maintain", 5, False) not in rec.kept:
        fail("maintain() ran no DHD step over the 5 per-DC heat fields")
    dhds = []
    for key in sorted(rec.kept, key=lambda k: (k[0] != "maintain", k)):
        phase, B, per_field = key
        heat, cols, vals, q, params = rec.kept[key]
        name = (f"{phase}, call {min(rec.calls[key], rec.KEEP_AT)} of "
                f"{rec.calls[key]}: {B} field(s), "
                f"{'per-field' if per_field else 'shared'} vals")
        d = check_dhd(name, heat, cols, vals, q, params)
        dhds.append(d)
        c, f = d["count"], d["flow"]
        print(f"dhd {name} {d['shape']}: count kernel {c['ms']:.4f} ms (host loop "
              f"{c['host_loop_ms']:.4f}, plain {c['plain_ms']:.4f}, bound {c['bound_ms']:.5f}), "
              f"flow kernel {f['ms']:.4f} ms (host loop {f['host_loop_ms']:.4f}, plain "
              f"{f['plain_ms']:.4f}, bound {f['bound_ms']:.5f}), max abs err "
              f"{f['max_abs_err']:.3g}; gathers count {d['count_gathers']}, flow "
              f"{d['flow_gathers']}, median |col - row| {d['median_col_distance']:.0f}",
              flush=True)
    # shapes the lane's recorded steps do not have: B with no divisor up to
    # 5 (one field a block), per-field vals in groups of 3, kmax past 96
    # (the flow kernel's slot loop)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    for B, n, kmax, per_field in ((7, 3000, 150, False), (6, 2000, 40, True)):
        shape = (B, n, kmax) if per_field else (n, kmax)
        vals = torch.rand(shape, generator=gen, device=DEVICE)
        vals *= torch.rand(shape, generator=gen, device=DEVICE) < 0.6
        cols = torch.randint(0, n, (n, kmax), generator=gen, device=DEVICE, dtype=torch.int32)
        heat, q = (torch.rand((B, n), generator=gen, device=DEVICE) for _ in range(2))
        name = (f"synthetic: {B} fields, {'per-field' if per_field else 'shared'} vals, "
                f"kmax {kmax}")
        d = check_dhd(name, heat, cols, vals, q, (0.5, 0.1, 0.3))
        dhds.append(d)
        print(f"dhd {name} {d['shape']}: count and flow within atol 1e-5 / rtol 1e-4, count "
              f"kernel {d['count']['ms']:.4f} ms, flow kernel {d['flow']['ms']:.4f} ms",
              flush=True)
    dhd_sweep(report)
    report["route_expand_checks"] = routes
    report["dhd_checks"] = dhds
    return {"route": routes[len(BATCHES) - 1], "dhd": dhds[0]}


def streaming_phase(store, report: dict):
    """Phase 5; returns the streaming launch counts and the sweep recorder."""
    from repro_torch.kernels import ops

    with SweepRecorder(ops, store) as rec:
        return _drive_streaming(store, report, rec), rec


def _drive_streaming(store, report: dict, rec: SweepRecorder) -> dict:
    import numpy as np
    import torch

    from repro_torch.convert import store_arrays, store_from_numpy
    from repro_torch.core.routing import route_online_batch
    from repro_torch.kernels.cuda_lib import reset_launch_counters
    from repro_torch.obs import Tracer
    from repro_torch.streaming import DeltaGraph, random_churn_batch

    counts = launch_counts

    def since(before):
        return {k: v - before[k] for k, v in counts().items() if v - before[k]}

    t = time.perf_counter()
    mirror = store_from_numpy(store_arrays(store), device="cpu")
    print(f"streaming: CPU mirror of the store built in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    store.tracer = Tracer(enabled=True)  # spans split apply_updates' host work
    store._delta_graph = DeltaGraph(store.g)
    mirror._delta_graph = DeltaGraph(mirror.g)
    rng = np.random.default_rng(7)
    ints = ("n_add_vertices", "n_del_vertices", "n_add_edges", "n_del_edges",
            "n_touched_vertices", "compacted")
    warm_ints = ("frontier_size", "halo_size", "local_iters", "global_iters")
    out: dict = {"batches": []}
    reset_launch_counters()
    for rate, n_batches in CHURN:
        for i in range(n_batches):
            rec.phase = f"apply {rate:g}"
            batch = random_churn_batch(store._delta_graph, rate, rng)
            before = counts()
            store.tracer.reset()
            if i == n_batches - 1:  # the warm batch of each rate, profiled
                wall_ms, busy_ms, by_kind, r = profiled(lambda: store.apply_updates(batch))
                wall_s, prof = wall_ms / 1e3, {"wall_ms": wall_ms, "device_ms": busy_ms,
                                               "device_share": busy_ms / wall_ms,
                                               "by_kind_ms": by_kind}
            else:
                t = time.perf_counter()
                r = store.apply_updates(batch)
                torch.cuda.synchronize()
                wall_s, prof = time.perf_counter() - t, None
            launches = since(before)
            spans = {sp.name: sp.dur_s for sp in store.tracer.records}
            t = time.perf_counter()
            m = mirror.apply_updates(batch)
            mirror_s = time.perf_counter() - t
            if [getattr(r, f) for f in ints] != [getattr(m, f) for f in ints]:
                fail(f"apply_updates({rate:g}) report differs from the CPU mirror's")
            if [getattr(r.heat, f) for f in warm_ints[:2]] != [
                getattr(m.heat, f) for f in warm_ints[:2]
            ]:
                fail(f"apply_updates({rate:g}): warm-DHD frontier differs from the mirror's")
            if not (np.array_equal(store.state.delta, mirror.state.delta)
                    and np.array_equal(store.route_index.nearest, mirror.route_index.nearest)):
                fail(f"apply_updates({rate:g}): replica sets or routes differ from the mirror's")
            heat_err = float(np.abs(store._heat.heat - mirror._heat.heat).max())
            if not np.allclose(store._heat.heat, mirror._heat.heat, **DHD_TOL):
                fail(f"apply_updates({rate:g}): heat outside atol 1e-5 / rtol 1e-4 of the "
                     f"mirror's (max abs err {heat_err:.3g})")
            row = {
                "rate": rate, "n_ops": int(batch.n_ops), "apply_s": wall_s,
                "mirror_apply_s": mirror_s, "spans_s": spans, "profiled": prof,
                "report": {f: int(getattr(r, f)) for f in ints},
                "warm": {f: int(getattr(r.heat, f)) for f in warm_ints},
                "mirror_warm": {f: int(getattr(m.heat, f)) for f in warm_ints},
                "residual": r.heat_residual, "heat_max_abs_err": heat_err,
                "n_rows": int(store._heat.cols.shape[0]),
                "kmax": int(store._heat.cols.shape[1]), "launches": launches,
            }
            out["batches"].append(row)
            w = row["warm"]
            print(f"apply_updates(rate {rate:g}, {batch.n_ops} ops): "
                  f"{wall_s:.3f} s{' (profiled)' if prof else ''}, mirror {mirror_s:.3f} s; "
                  f"touched {r.n_touched_vertices}, frontier {w['frontier_size']}, "
                  f"halo {w['halo_size']}, local iters {w['local_iters']}, global iters "
                  f"{w['global_iters']} (mirror {row['mirror_warm']['global_iters']}), "
                  f"residual {r.heat_residual:.3g}, heat max abs err {heat_err:.3g}; "
                  f"ELL {row['n_rows']} x {row['kmax']}; launches {launches}; spans "
                  + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()), flush=True)
            if prof:
                print(f"  device busy {busy_ms:.4f} ms of {wall_ms:.3f} ms, share "
                      f"{busy_ms / wall_ms:.5f}; "
                      + ", ".join(f"{k.strip()} {v:.4f}" for k, v in by_kind.items()),
                      flush=True)
    if not any(b["warm"]["local_iters"] > 0 for b in out["batches"]):
        fail("no streaming batch took the frontier pre-solve")

    rec.phase = "flush"
    before = counts()
    t = time.perf_counter()
    plan = store.flush_migrations()
    flush_s = time.perf_counter() - t
    flush_launches = since(before)
    t = time.perf_counter()
    mplan = mirror.flush_migrations()
    mirror_flush_s = time.perf_counter() - t
    moves = {(x.item, x.dc, x.kind) for x in plan.moves}
    mmoves = {(x.item, x.dc, x.kind) for x in mplan.moves}
    rows = int((store.state.delta != mirror.state.delta).any(axis=1).sum())
    out["flush"] = {"moves": len(plan.moves), "adds": plan.n_adds,
                    "waves": plan.schedule.n_waves, "flush_s": flush_s,
                    "mirror_flush_s": mirror_flush_s, "moves_differing": len(moves ^ mmoves),
                    "delta_rows_differing": rows, "launches": flush_launches}
    print(f"flush_migrations: {len(plan.moves)} moves ({plan.n_adds} adds) in "
          f"{plan.schedule.n_waves} waves, {flush_s:.3f} s (mirror {mirror_flush_s:.3f} s); "
          f"{len(moves ^ mmoves)} moves and {rows} state.delta rows differ from the "
          f"mirror's; launches {flush_launches}", flush=True)

    for phase, fn in (("maintain", store.maintain), ("compact", store.compact)):
        rec.phase = phase
        before = counts()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[phase] = {"s": time.perf_counter() - t, "launches": since(before),
                      "result": res}
        print(f"{phase}: {res} in {out[phase]['s']:.3f} s, launches "
              f"{out[phase]['launches']}", flush=True)
    if store._heat.n_nodes != store.g.n_nodes or store.tombstone_ratio() != 0.0:
        fail("compact() left tombstones or a stale heat field")

    reqs = request_stream(store, BATCHES[-1], seed=BATCHES[-1])
    got = store.serve_batch(reqs, observe=False)
    want = route_online_batch(store.lg, store.state, reqs, fast=False)
    if not same_results(got, want):
        fail("serve_batch(1024) after churn differs from the numpy router")
    times = []
    for _ in range(5):
        t = time.perf_counter()
        store.serve_batch(reqs, observe=False)
        times.append(time.perf_counter() - t)
    med = float(np.median(times))
    out["serve_1024"] = {"median_s": med, "rps": BATCHES[-1] / med, "times_s": times,
                         "n_items": int(store.g.n_items)}
    total = counts()
    out["launches"] = total
    print(f"serve_batch(1024) after churn, flush and compaction ({store.g.n_items} "
          f"items): identical to the numpy router, median {med * 1e3:.3f} ms, "
          f"{BATCHES[-1] / med:.1f} routed requests/s", flush=True)
    print(f"launches on the streaming path: {total}", flush=True)
    by_shape = {", ".join(map(str, k)): v for k, v in sorted(rec.by_shape.items())}
    out["dhd_steps_by_shape"] = by_shape
    print(f"single-field DHD steps (one count + one flow launch each) by phase, n, kmax: "
          f"{by_shape}", flush=True)
    differ = [i for i, b in enumerate(out["batches"]) if b["warm"] != b["mirror_warm"]]
    out["warm_stats_differing"] = differ
    print(f"warm-DHD stats (frontier, halo, local and global iterations) differ from the "
          f"mirror's in {len(differ)} of {len(out['batches'])} batches"
          + (": " + "; ".join(f"batch {i + 1}: {out['batches'][i]['warm']} vs mirror "
                              f"{out['batches'][i]['mirror_warm']}" for i in differ)
             if differ else ""), flush=True)
    for name in SINGLE_KERNELS:
        if total[name] <= 0:
            fail(f"kernel {name} was not launched on the streaming path")
    report["streaming"] = out
    return total


def check_dhd_single(name, heat, cols, vals, q, params, timed: bool = True) -> dict:
    """The single-field count and flow kernels vs their plain versions on
    the card, over 4 chained steps from a recorded sweep input."""
    import torch

    from repro_torch.kernels.cuda_lib import library, stream_ptr
    from repro_torch.kernels.dhd_spmv import dhd_ell_step
    from repro_torch.kernels.ref import dhd_ell_count_ref, dhd_ell_flow_ref, dhd_ell_ref

    lib = library().get()
    n, kmax = cols.shape
    alpha, gamma, beta = (float(x) for x in params)
    p = dict(alpha=alpha, gamma=gamma, beta=beta)
    nout = torch.empty_like(heat)
    out = torch.empty_like(heat)

    def count(h):
        lib.dhd_count_single(h.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                             nout.data_ptr(), n, kmax, stream_ptr(h.device))

    def flow(h):
        lib.dhd_flow_single(h.data_ptr(), nout.data_ptr(), cols.data_ptr(),
                            vals.data_ptr(), q.data_ptr(), out.data_ptr(), n, kmax,
                            alpha, 1.0 - gamma, beta, stream_ptr(h.device))

    def count_ref(h):
        return dhd_ell_count_ref(h[None], cols, vals)[0]

    def flow_ref(h, n_out):
        return dhd_ell_flow_ref(h[None], n_out[None], cols, vals, q[None], **p)[0]

    err_count = err_flow = 0.0
    for _ in range(4):
        count(heat)
        want_n = count_ref(heat)
        flow(heat)
        want = flow_ref(heat, want_n)
        step = dhd_ell_step(heat, cols, vals, q, **p)
        full = dhd_ell_ref(heat, cols, vals, q, **p)
        torch.cuda.synchronize()
        if not torch.equal(nout, want_n):
            fail(f"dhd_count_single {name}: |N_out| differs from the plain version")
        for got in (out, step):
            if not torch.allclose(got, want, **DHD_TOL):
                fail(f"dhd_flow_single {name}: outside atol 1e-5 / rtol 1e-4")
        if not torch.allclose(step, full, **DHD_TOL):
            fail(f"dhd_ell_step {name}: outside atol 1e-5 / rtol 1e-4")
        err_count = max(err_count, float((nout - want_n).abs().max()))
        err_flow = max(err_flow, float((out - want).abs().max()))
        heat = want
    row = {"case": name, "shape": [n, kmax], "count": {"max_abs_err": err_count},
           "flow": {"max_abs_err": err_flow}}
    if not timed:
        return row
    count(heat)
    ell = cols.numel() * 4 + vals.numel() * 4
    count_bytes = ell + 2 * n * 4  # heat in, |N_out| out
    flow_bytes = ell + 4 * n * 4  # heat, |N_out|, q in, heat out
    live = vals > 0
    inflow = live & (heat[cols.long()] > heat[:, None])
    row.update(count_gathers=int(live.sum()), flow_gathers=int(live.sum()) + int(inflow.sum()))
    row["count"].update(
        **kernel_ms(lambda: count(heat)), plain_ms=host_loop_ms(lambda: count_ref(heat)),
        bytes=count_bytes, bound_ms=count_bytes / HBM_BYTES_PER_S * 1e3)
    row["flow"].update(
        **kernel_ms(lambda: flow(heat)), plain_ms=host_loop_ms(lambda: flow_ref(heat, nout)),
        bytes=flow_bytes, bound_ms=flow_bytes / HBM_BYTES_PER_S * 1e3)
    return row


def dhd_single_sweep(report: dict) -> None:
    """Phase 6's sweep: the single-field kernels against their plain
    versions on every ``DHD_SINGLE_SWEEP`` case (tie-heavy heat, pad rows;
    a base that is not 16-byte aligned takes the scalar loads)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    rows = []
    for n, kmax, aligned in DHD_SINGLE_SWEEP:
        heat, cols, vals, q = tie_problem(gen, 1, n, kmax, False, single=True)
        if not aligned:  # the same values one element past an aligned base
            cols = torch.empty(n * kmax + 1, dtype=cols.dtype, device=DEVICE)[1:].view(
                n, kmax).copy_(cols)
            vals = torch.empty(n * kmax + 1, device=DEVICE)[1:].view(n, kmax).copy_(vals)
        name = f"sweep: n {n}, kmax {kmax}{'' if aligned else ', base not 16-byte aligned'}"
        rows.append(check_dhd_single(name, heat, cols, vals, q, (0.5, 0.1, 0.3), timed=False))
    report["dhd_single_sweep"] = rows
    print(f"dhd single sweep: {len(rows)} cases (kmax 80/71/150/37/32/400, n 10,007 and 3, "
          f"a misaligned base, tie-heavy heat, pad rows): counts equal, flows within atol "
          f"1e-5 / rtol 1e-4, max abs err {max(r['flow']['max_abs_err'] for r in rows):.3g}",
          flush=True)
    print(f"  ptxas: {ptxas_of(report, 'dhd_flow_single_kernel')}", flush=True)


def streaming_kernel_checks(rec: SweepRecorder, report: dict) -> dict:
    """Phase 6; returns the single-field kernels' rows: the last recorded
    global sweep of the 0.01 batches (``"global"``) and the first pre-solve
    sweep (``"presolve"``).  Every recorded kind is checked."""
    glob = sorted(k for k in rec.kept if k[:2] == (f"apply {CHURN[0][0]:g}", "global"))
    pre = sorted(k for k in rec.kept if k[1] == "pre-solve")
    if not glob or not pre:
        fail(f"a global or a pre-solve sweep was not recorded: {sorted(rec.kept)}")
    checks, rows = [], {}
    for key in sorted(rec.kept):
        heat, cols, vals, q, params = rec.kept[key]
        name = (f"{key[0]}, {key[1]} sweep, call {min(rec.calls[key], rec.KEEP_AT)} "
                f"of {rec.calls[key]}: {key[2]} rows")
        d = check_dhd_single(name, heat, cols, vals, q, params)
        checks.append(d)
        if key == glob[-1]:
            rows["global"] = d
        if key == pre[0]:
            rows["presolve"] = d
        c, f = d["count"], d["flow"]
        print(f"dhd single {name} {d['shape']}: count kernel {c['ms']:.4f} ms (host loop "
              f"{c['host_loop_ms']:.4f}, plain {c['plain_ms']:.4f}, bound {c['bound_ms']:.5f}), "
              f"flow kernel {f['ms']:.4f} ms (host loop {f['host_loop_ms']:.4f}, plain "
              f"{f['plain_ms']:.4f}, bound {f['bound_ms']:.5f}), max abs err "
              f"{f['max_abs_err']:.3g}; gathers count {d['count_gathers']}, flow "
              f"{d['flow_gathers']}", flush=True)
    report["dhd_single_checks"] = checks
    dhd_single_sweep(report)
    return rows


def cpu_build_diff(inputs, built_delta, report: dict) -> None:
    """Phase 5: the same store built with the plain versions on the host
    (edge-form DHD), against the card's replica sets as built."""
    from repro_torch.core.placement import PlacementConfig
    from repro_torch.core.store import GeoGraphStore

    g, env, wl = inputs
    t = time.perf_counter()
    cpu = GeoGraphStore(g, env, wl, config=PlacementConfig(), device="cpu")
    cpu_s = time.perf_counter() - t
    rows = (cpu.state.delta != built_delta).any(axis=1)
    diff = int(rows.sum())
    report["cpu_build"] = {"build_s": cpu_s, "delta_rows_differing": diff,
                           "replicas_card": int(built_delta.sum()),
                           "replicas_cpu": int(cpu.state.delta.sum())}
    print(f"CPU build of the same store: {cpu_s:.3f} s, {diff} state.delta rows "
          f"differ from the card's build", flush=True)


# ---------------------------------------------------------------- slice F1
class AttentionRecorder:
    """Installed over ``kernels.ops.attention`` (the name the MLA prefill
    calls) for the LM serving run: passes every call on unchanged and keeps
    q, k, v of layer 0 of each prefill (every ``n_layers``-th call), keyed
    by prompt length.  Prefill never writes into them."""

    def __init__(self, ops, n_layers: int) -> None:
        self.ops = ops
        self.fn = ops.attention
        self.n_layers = n_layers
        self.calls = 0
        self.kept: dict = {}

    def __call__(self, q, k, v, causal=True, window=None):
        if self.calls % self.n_layers == 0:
            self.kept[int(q.shape[2])] = (q, k, v, causal, window)
        self.calls += 1
        return self.fn(q, k, v, causal=causal, window=window)

    def __enter__(self) -> "AttentionRecorder":
        self.ops.attention = self
        return self

    def __exit__(self, *exc) -> None:
        self.ops.attention = self.fn


class StepTimer:
    """Installed over ``models.transformer.prefill`` and ``decode`` (the
    names the engine calls): times each call to a synchronised device and
    fails on a non-finite logit."""

    def __init__(self, tf) -> None:
        self.tf = tf
        self.prefill, self.decode = tf.prefill, tf.decode
        self.prefills: list = []
        self.decodes: list = []

    def _timed(self, fn, args, log: list, row: dict):
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = fn(*args)
        finite = bool(torch.isfinite(logits).all())  # synchronises
        row["ms"] = (time.perf_counter() - t) * 1e3
        log.append(row)
        if not finite:
            fail(f"non-finite logits in {row}")
        return logits, caches

    def _prefill(self, params, tokens, cfg):
        return self._timed(self.prefill, (params, tokens, cfg), self.prefills,
                           {"tokens": int(tokens.shape[1])})

    def _decode(self, params, token, caches, position, cfg):
        return self._timed(self.decode, (params, token, caches, position, cfg),
                           self.decodes, {})

    def __enter__(self) -> "StepTimer":
        self.tf.prefill, self.tf.decode = self._prefill, self._decode
        return self

    def __exit__(self, *exc) -> None:
        self.tf.prefill, self.tf.decode = self.prefill, self.decode


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def lm_serving_phase(report: dict) -> dict:
    """Phase 8: ``deepseek-v2-lite-16b`` at full width in bf16 (random
    weights drawn on the card from seed 0), served through ``Engine`` with
    4 slots and 1,024 positions: 8 requests of 64-700 prompt tokens, 16 new
    tokens each.  Counts set to 0 just before the engine runs, read just
    after: every prefill must take the flash-attention kernel in each
    layer.  Then one prefill and one decode step under the profiler."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Engine, Request, ServeConfig

    cfg = get_arch(LM_ARCH).cfg
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weight_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"{LM_ARCH}: {n_params / 1e9:.3f} B parameters ({weight_bytes / 1e9:.2f} GB at rest) "
          f"drawn on the card in {init_s:.2f} s", flush=True)

    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(64, 701, LM_REQUESTS)]
    if not (any(n % 64 for n in lens) and any(n >= 512 for n in lens)):
        fail(f"prompt lengths {lens} miss a ragged or a >= 512-token prompt")
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    eng = Engine(params, cfg, ServeConfig(n_slots=LM_SLOTS, max_len=LM_MAX_LEN), device=DEVICE)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=LM_NEW))
    with AttentionRecorder(ops, cfg.n_layers) as rec, StepTimer(tf) as timer:
        reset_launch_counters()
        t = time.perf_counter()
        done = eng.run_to_completion()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        launches = {k: c.n for k, c in launch_counters().items() if c.n}
    if sorted(r.rid for r in done) != list(range(LM_REQUESTS)):
        fail(f"the engine completed {sorted(r.rid for r in done)} of {LM_REQUESTS} requests")
    if any(len(r.out_tokens) != LM_NEW for r in done):
        fail("a request completed without its 16 new tokens")
    want = cfg.n_layers * LM_REQUESTS
    if launches.get("flash_attention", 0) <= 0:
        fail("kernel flash_attention was not launched on the LM serving path")
    if launches.get("flash_attention") != want or set(launches) != {"flash_attention"}:
        fail(f"LM serving launches {launches}, want flash_attention {want} and nothing else")
    gen_tokens = LM_REQUESTS * LM_NEW
    dec_ms = [d["ms"] for d in timer.decodes]
    peak = torch.cuda.max_memory_allocated()
    print(f"LM serving: {LM_REQUESTS} requests, {gen_tokens} new tokens in {wall_s:.3f} s "
          f"({gen_tokens / wall_s:.1f} tokens/s); {len(timer.prefills)} prefills, "
          f"{len(dec_ms)} decode steps; launches {launches}; peak memory "
          f"{peak / 1e9:.2f} GB", flush=True)
    for p in timer.prefills:
        print(f"  prefill {p['tokens']} tokens: {p['ms']:.2f} ms", flush=True)
    print(f"  decode step ({LM_SLOTS} slots): median {float(np.median(dec_ms)):.2f} ms, "
          f"first {dec_ms[0]:.2f}, min {min(dec_ms):.2f}, max {max(dec_ms):.2f} ms", flush=True)

    longest = prompts[int(np.argmax(lens))]
    tok = torch.as_tensor(longest[None], device=DEVICE)
    token = torch.zeros(LM_SLOTS, dtype=torch.long, device=DEVICE)
    pos = torch.as_tensor(eng.pos, dtype=torch.long, device=DEVICE)
    prof = {}
    with torch.inference_mode():
        for name, fn in (("prefill", lambda: tf.prefill(params, tok, cfg)),
                         ("decode", lambda: tf.decode(params, token, eng.caches, pos, cfg))):
            fn()
            host: dict = {}
            wall_ms, busy_ms, by_kind, _ = profiled(fn, host=host)
            top = dict(sorted(by_kind.items(), key=lambda kv: -kv[1])[:8])
            prof[name] = {"wall_ms": wall_ms, "device_ms": busy_ms,
                          "device_share": busy_ms / wall_ms, "top_ms": top, "host_top": host}
            print(f"  {name} ({len(longest) if name == 'prefill' else LM_SLOTS} tokens) "
                  f"profiled: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms, share "
                  f"{busy_ms / wall_ms:.4f}; top: "
                  + ", ".join(f"{k.strip()[:40]} {v:.3f}" for k, v in top.items()), flush=True)
            print("    host ops by self CPU ms: " + ", ".join(
                f"{k.strip()[:30]} {v['self_cpu_ms']:.2f} ({v['calls']} calls)"
                for k, v in host.items()), flush=True)
    report["lm_serving"] = {
        "arch": LM_ARCH, "n_params": n_params, "weight_bytes": weight_bytes,
        "init_s": init_s, "prompt_lens": lens, "wall_s": wall_s,
        "tokens_per_s": gen_tokens / wall_s, "prefills": timer.prefills,
        "decode_ms": dec_ms, "peak_memory_bytes": peak, "launches": launches,
        "profiled": prof,
    }
    return {"cfg": cfg, "params": params, "tokens": tok, "kept": rec.kept,
            "launches": launches}


def lm_end_to_end_check(lm: dict, report: dict) -> None:
    """Phase 9: the prefill with the kernel against the same prefill with
    ``ops.attention`` swapped for its plain version.  A 2-layer model at
    full width in f32 must agree within atol/rtol 1e-3; on the full-depth
    bf16 model the last position's logits are reported (max abs and
    relative RMS difference, top-1 agreement), not failed, beside
    controls: the same prefill with SDPA, and with the f32 kernel on
    upcast inputs, in the kernel's place, against the plain version, which
    read how far sound bf16 attentions drift apart over the full depth; and
    for each, layer 0's outputs on their recorded inputs: how many differ
    from the plain version's and their RMS distance to f64."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import transformer as tf

    def plain(q, k, v, causal=True, window=None):
        return attention_ref(q, k, v, causal=causal, window=window)

    def sdpa(q, k, v, causal=True, window=None):
        if window is not None:
            fail("the SDPA control covers no sliding window")
        return _sdpa(q, k, v, causal)

    def f32_kernel(q, k, v, causal=True, window=None):
        return flash_attention(q.float(), k.float(), v.float(), causal=causal,
                               window=window).to(q.dtype)

    def prefill_with(params, cfg, tokens, fn=None):
        """Last logits of one prefill, with ``fn`` in ``ops.attention``'s
        place when given."""
        kernel_fn = ops.attention
        ops.attention = fn or kernel_fn
        try:
            with torch.inference_mode():
                return tf.prefill(params, tokens, cfg)[0].float()
        finally:
            ops.attention = kernel_fn

    def gap(got, want) -> dict:
        diff = got - want
        rms = float(want.pow(2).mean().sqrt())
        return {"max_abs_diff": float(diff.abs().max()),
                "rel_rms_diff": float(diff.pow(2).mean().sqrt()) / rms,
                "top1_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
                "logit_rms": rms}

    cfg2 = dataclasses.replace(lm["cfg"], n_layers=2, dtype=torch.float32)
    params2 = tf.init_params(cfg2, torch.Generator(device=DEVICE).manual_seed(1), DEVICE)
    got = prefill_with(params2, cfg2, lm["tokens"])
    want = prefill_with(params2, cfg2, lm["tokens"], plain)
    del params2
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **E2E_TOL))
    print(f"end to end, 2 layers at full width in f32, {lm['tokens'].shape[1]}-token prefill: "
          f"last logits max abs diff kernel vs plain {err:.3g} "
          f"({'within' if ok else 'OUTSIDE'} atol/rtol 1e-3)", flush=True)
    if not ok:
        fail("the f32 2-layer prefill with the flash kernel differs from the plain version")
    want = prefill_with(lm["params"], lm["cfg"], lm["tokens"], plain)
    # layer 0's attention alone, on its recorded inputs: how many bf16
    # outputs differ from the plain version's, and the RMS distance to the
    # same attention in f64 (the plain version's own is bf16 rounding)
    q, k, v, causal, window = lm["kept"][max(lm["kept"])]
    exact = attention_ref(q.double(), k.double(), v.double(), causal=causal, window=window)
    base = plain(q, k, v, causal, window).float()
    rows = {}
    for name, fn in (("kernel", flash_attention), ("control, SDPA", sdpa),
                     ("control, f32 kernel", f32_kernel), ("plain", plain)):
        o = fn(q, k, v, causal=causal, window=window).float()
        g = gap(prefill_with(lm["params"], lm["cfg"], lm["tokens"], fn), want)
        g.update(layer0_outputs_differing=int((o != base).sum()), layer0_outputs=o.numel(),
                 layer0_rms_vs_f64=float((o.double() - exact).pow(2).mean().sqrt()))
        rows[name] = g
        print(f"end to end, full depth in bf16, {name} vs plain: last logits max abs diff "
              f"{g['max_abs_diff']:.4g}, relative RMS diff {g['rel_rms_diff']:.4g} "
              f"(logit RMS {g['logit_rms']:.4g}), top-1 agreement {g['top1_agreement']:.3f}; "
              f"layer 0: {g['layer0_outputs_differing']} of {o.numel()} outputs differ from "
              f"the plain version's, RMS vs f64 {g['layer0_rms_vs_f64']:.4g}", flush=True)
    report["lm_end_to_end"] = {"f32_2_layers": {"max_abs_diff": err, "ok": ok},
                               "bf16_full_depth": rows}


def attention_bound(q, k, v, causal: bool, window) -> tuple:
    """``(bound ms, bound_by, flops, bytes)`` of one attention call: the
    unmasked q.k pairs times 2 (Dqk + Dv) flops at the bf16 dense peak
    against q, k, v read and the output written once at 3.35 TB/s."""
    B, Hq, Sq, dqk = q.shape
    Skv, dv = k.shape[2], v.shape[3]
    pairs = 0
    for i in range(Sq):
        pos = i + Skv - Sq
        hi = min(Skv, pos + 1) if causal else Skv
        lo = max(0, pos - window + 1) if window is not None else 0
        pairs += max(0, hi - lo)
    flops = 2 * B * Hq * pairs * (dqk + dv)
    size = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + B * Hq * Sq * dv) * size
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes"), flops, nbytes


def _sdpa(q, k, v, causal: bool):
    import torch.nn.functional as F

    gqa = {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal, **gqa)


def attention_kernel_checks(lm: dict, report: dict) -> dict:
    """Phase 10: the flash kernel against its plain version on the card on
    layer 0's q, k, v of the longest and the shortest prompt, in bf16
    (2e-2) and cast to f32 (2e-5).  On layer 0's inputs of every prompt
    length, the kernel (its C entry point) and SDPA graph-replayed in
    turns beside the bound; the plain version and the host-loop figures at
    the longest and the shortest.  Returns the kernel table row (longest
    prompt, bf16)."""
    import torch
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels.cuda_lib import library, stream_ptr
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    kept = lm["kept"]
    if len(kept) != LM_REQUESTS:
        fail(f"recorded layer-0 attention inputs of {len(kept)} prefills, want {LM_REQUESTS}")
    lib = library().get()
    checks, by_length, err_bf16 = [], [], 0.0
    for S in sorted(kept, reverse=True):
        q, k, v, causal, window = kept[S]
        out = torch.empty((q.shape[0], q.shape[1], S, v.shape[3]), dtype=q.dtype,
                          device=q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0],
                q.shape[1], k.shape[1], S, k.shape[2], q.shape[3], v.shape[3],
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                float(q.shape[3] ** -0.5), int(causal), int(window is not None),
                int(window or 0), 1)

        def launch():
            lib.flash_attention_fwd(*args, stream_ptr(q.device))

        def sdpa():
            _sdpa(q, k, v, causal)

        bound_ms, bound_by, flops, nbytes = attention_bound(q, k, v, causal, window)
        # each a graph of 20 calls, replayed in turns: medians of 9 replays
        ms, sdpa_ms = cuda_ms_in_turns([launch, sdpa], reps=9)
        by_length.append({"tokens": S, "ms": ms, "sdpa_ms": sdpa_ms, "bound_ms": bound_ms})
        if S not in (max(kept), min(kept)):
            continue
        row = {"tokens": S, "shape": {"q": list(q.shape), "k": list(k.shape),
                                      "v": list(v.shape)}}
        for name, cast in (("bfloat16", lambda x: x), ("float32", lambda x: x.float())):
            qc, kc, vc = cast(q), cast(k), cast(v)
            got = flash_attention(qc, kc, vc, causal=causal, window=window)
            want = attention_ref(qc, kc, vc, causal=causal, window=window)
            torch.cuda.synchronize()
            tol = ATTN_TOL[name]
            err = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
                fail(f"flash_attention at {S} tokens in {name}: max abs err {err:.3g} "
                     f"outside {tol}")
            row[f"max_abs_err_{name}"] = err
        err_bf16 = max(err_bf16, row["max_abs_err_bfloat16"])
        backend = SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=causal)).name
        row.update(
            ms=ms, host_loop_ms=host_loop_ms(launch),
            plain_ms=host_loop_ms(lambda: attention_ref(q, k, v, causal=causal)),
            sdpa_ms=sdpa_ms, sdpa_host_loop_ms=host_loop_ms(sdpa), sdpa_backend=backend,
            flops=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
        )
        checks.append(row)
        print(f"flash_attention layer 0 at {S} tokens q {tuple(q.shape)} v {tuple(v.shape)} "
              f"bf16: max abs err {row['max_abs_err_bfloat16']:.3g} (f32 "
              f"{row['max_abs_err_float32']:.3g}); kernel {ms:.4f} ms, SDPA ({backend}) "
              f"{sdpa_ms:.4f} ms in turns (host loop: kernel {row['host_loop_ms']:.4f}, SDPA "
              f"{row['sdpa_host_loop_ms']:.4f}), plain {row['plain_ms']:.4f} ms; bound "
              f"{bound_ms:.5f} ms by {bound_by} ({flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB)", flush=True)
    # launches x (time - bound) at every prefill's own shape
    print("flash_attention by prompt length, graph-replayed in turns with SDPA (tokens: "
          "kernel / SDPA / bound ms): " + ", ".join(
              f"{r['tokens']}: {r['ms']:.4f} / {r['sdpa_ms']:.4f} / {r['bound_ms']:.5f}"
              for r in by_length[::-1]), flush=True)
    report["flash_attention_checks"] = checks
    report["flash_attention_by_length"] = by_length
    top = checks[0]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:29",
            "launches": lm["launches"]["flash_attention"], "max_abs_err": err_bf16,
            "ms": top["ms"], "host_loop_ms": top["host_loop_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["sdpa_ms"]}


def attention_sweep(report: dict) -> None:
    """Phase 10's sweep: the flash kernel against its plain version on
    seeded inputs of every ``ATTN_SWEEP`` case, in bf16 (2e-2) and f32
    (2e-5).  Query rows that see no key must come out exactly 0, and a bf16
    view whose rows the kernel cannot copy in 16-byte pieces must raise
    before a launch."""
    import torch

    from repro_torch.kernels.flash_attention import LAUNCHES, flash_attention
    from repro_torch.kernels.ref import attention_ref

    gen = torch.Generator(device=DEVICE).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    rows = []
    for name, B, Hq, Hkv, Sq, Skv, dqk, dv, causal, window, v_t in ATTN_SWEEP:
        q, k = randn(B, Hq, Sq, dqk), randn(B, Hkv, Skv, dqk)
        v = randn(B, Skv, Hkv, dv).transpose(1, 2) if v_t else randn(B, Hkv, Skv, dv)
        row = {"case": name, "shape": [B, Hq, Hkv, Sq, Skv, dqk, dv], "causal": causal,
               "window": window, "v_transposed": v_t}
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            qc, kc, vc = q.to(dt), k.to(dt), v.to(dt)
            got = flash_attention(qc, kc, vc, causal=causal, window=window)
            want = attention_ref(qc, kc, vc, causal=causal, window=window)
            torch.cuda.synchronize()
            tol = ATTN_TOL[dtype]
            err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
            if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
                fail(f"flash_attention sweep '{name}' in {dtype}: max abs err {err:.3g} "
                     f"outside {tol}")
            if causal and Sq > Skv and got[:, :, : Sq - Skv].any():
                fail(f"flash_attention sweep '{name}' in {dtype}: a fully masked row is not 0")
            row[f"max_abs_err_{dtype}"] = err
        rows.append(row)
    before = LAUNCHES.n
    base = torch.zeros((1, 2, 64, 25), dtype=torch.bfloat16, device=DEVICE)
    try:
        flash_attention(base[..., :24], base[..., :24], base[..., :24])
    except ValueError:
        pass
    else:
        fail("flash_attention took a bf16 view with a 25-element row stride")
    if LAUNCHES.n != before:
        fail("flash_attention launched on a view it refused")
    print(f"flash_attention sweep: {len(rows)} cases within {ATTN_TOL['bfloat16']} (bf16) and "
          f"{ATTN_TOL['float32']} (f32), max abs err bf16 "
          f"{max(r['max_abs_err_bfloat16'] for r in rows):.3g}, f32 "
          f"{max(r['max_abs_err_float32'] for r in rows):.3g}; fully masked rows 0; a "
          f"misaligned bf16 view raises", flush=True)
    report["flash_attention_sweep"] = rows


def bag_inputs():
    """Phase 11's inputs: BST's item table (2^22 x 32, f32, seeded on the
    card) and, for each of ``BAG_BATCHES``, ``(B, ids, weights)`` with
    Zipf(1.1) ids, ``BAG_L`` a bag."""
    import numpy as np
    import torch

    from repro_torch.models.recsys.embedding import table_init

    table = table_init(torch.Generator(device=DEVICE).manual_seed(2), BAG_V, BAG_D,
                       device=DEVICE)
    rng = np.random.default_rng(1)
    bags = []
    for B in BAG_BATCHES:
        ids = torch.as_tensor((rng.zipf(1.1, (B, BAG_L)) % BAG_V).astype(np.int32),
                              device=DEVICE)
        w = torch.as_tensor(rng.random((B, BAG_L)).astype(np.float32), device=DEVICE)
        bags.append((B, ids, w))
    return table, bags


def bag_phase(report: dict) -> dict:
    """Phase 11: BST's item table (2^22 x 32, f32, seeded on the card) and
    Zipf(1.1) ids, 20 a bag, weighted, at the serving batches 512 and
    262,144, in sum and mean, through ``models.recsys.embedding.bag_lookup``
    with counts set to 0 just before and read just after: each result
    within 1e-4 of the plain version.  Times of the kernel (C entry point),
    the plain version and ``F.embedding_bag`` (sum mode) beside the bound.
    Returns the kernel table row (262,144 bags, sum)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.cuda_lib import (
        launch_counters,
        library,
        reset_launch_counters,
        stream_ptr,
    )
    from repro_torch.kernels.embedding_bag import instance
    from repro_torch.kernels.ref import embedding_bag_ref
    from repro_torch.models.recsys.embedding import bag_lookup

    table, bags = bag_inputs()
    reset_launch_counters()
    results = []
    for B, ids, w in bags:
        for mode in ("sum", "mean"):
            results.append((B, mode, bag_lookup(table, ids, w, mode=mode, dtype=torch.float32)))
    torch.cuda.synchronize()
    launches = {k: c.n for k, c in launch_counters().items() if c.n}
    if launches.get("embedding_bag", 0) <= 0:
        fail("kernel embedding_bag was not launched through bag_lookup")
    lib = library().get()
    rows, err_max = [], 0.0
    for (B, mode, got), (_, ids, w) in zip(results, [b for b in bags for _ in range(2)]):
        want = embedding_bag_ref(table, ids, w, mode=mode)
        err = float((got - want).abs().max())
        err_max = max(err_max, err)
        if not torch.allclose(got, want, **BAG_TOL):
            fail(f"embedding_bag B={B} {mode}: max abs err {err:.3g} outside 1e-4")
        uniq = int(torch.unique(ids).numel())
        nbytes = uniq * BAG_D * 4 + ids.numel() * 8 + B * BAG_D * 4
        out = torch.empty_like(got)
        args = (table.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(), B, BAG_L,
                BAG_V, BAG_D, int(mode == "mean"), 0)

        def launch():
            lib.embedding_bag_fwd(*args, stream_ptr(table.device))

        row = {"B": B, "mode": mode, "max_abs_err": err, "unique_rows": uniq, "bytes": nbytes,
               "instance": instance(table, ids),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, **kernel_ms(launch),
               "plain_ms": host_loop_ms(lambda: embedding_bag_ref(table, ids, w, mode=mode))}
        if mode == "sum":
            ids64 = ids.long()
            row["library_ms"] = cuda_ms(lambda: F.embedding_bag(
                ids64, table, mode="sum", per_sample_weights=w))
            lib_out = F.embedding_bag(ids64, table, mode="sum", per_sample_weights=w)
            row["library_max_abs_diff"] = float((lib_out - got).abs().max())
        rows.append(row)
        print(f"embedding_bag B={B} L={BAG_L} {mode} (instance {row['instance']}: dtype, "
              f"bytes a load, lanes a row, rows a lane in flight): max abs err {err:.3g}; "
              f"{uniq} distinct "
              f"rows; kernel {row['ms']:.4f} ms (host loop {row['host_loop_ms']:.4f}), plain "
              f"{row['plain_ms']:.4f} ms"
              + (f", F.embedding_bag {row['library_ms']:.4f} ms" if mode == "sum" else "")
              + f"; bound {row['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB)", flush=True)
    print(f"launches through bag_lookup: {launches}", flush=True)
    report["embedding_bag"] = {"launches": launches, "checks": rows}
    del table, bags
    err_max = max(err_max, bag_sweep(report))
    top = next(r for r in rows if r["B"] == BAG_BATCHES[-1] and r["mode"] == "sum")
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:27",
            "launches": launches["embedding_bag"], "max_abs_err": err_max,
            "ms": top["ms"], "host_loop_ms": top["host_loop_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes", "library_ms": top["library_ms"]}


# phase 11's sweep: dtype, D, B, L, mode, weights ("rand", "none" or "zero"),
# base 16-byte aligned; the instances' branches: 16-byte loads by 4, 8, 16
# and 32 lanes a row, rows wider than 32 loads, one element a load (D = 33
# and a misaligned base), no ids, one id, more than one chunk of 32 ids, and
# a B that leaves the last block of 8 bags partial
BAG_SWEEP = (
    ("float32", 16, 1003, 20, "sum", "rand", True),
    ("float32", 32, 9, 0, "sum", "rand", True),
    ("float32", 32, 517, 1, "mean", "rand", True),
    ("float32", 32, 517, 33, "sum", "none", True),
    ("float32", 32, 1003, 20, "mean", "zero", True),
    ("float32", 32, 1003, 20, "sum", "rand", False),
    ("float32", 48, 1003, 64, "mean", "rand", True),
    ("float32", 64, 1003, 20, "sum", "rand", True),
    ("float32", 128, 517, 33, "mean", "rand", True),
    ("float32", 256, 517, 20, "sum", "rand", True),
    ("float32", 33, 1003, 20, "sum", "rand", True),
    ("float32", 33, 517, 64, "mean", "none", True),
    ("bfloat16", 32, 1003, 20, "sum", "rand", True),
    ("bfloat16", 16, 1003, 64, "sum", "rand", True),
    ("bfloat16", 48, 517, 33, "mean", "none", True),
    ("bfloat16", 64, 9, 0, "mean", "rand", True),
    ("bfloat16", 128, 517, 1, "mean", "rand", True),
    ("bfloat16", 33, 1003, 20, "sum", "rand", True),
    ("bfloat16", 32, 1003, 20, "mean", "zero", True),
    ("bfloat16", 32, 1003, 20, "sum", "rand", False),
)
BAG_SWEEP_V = 5000


def bag_sweep(report: dict) -> float:
    """Phase 11's sweep: the kernel (through the wrapper) against its plain
    version on every ``BAG_SWEEP`` case, within 1e-4; ids Zipf(1.1) with
    one past the end and -1 in the first bag (both clamp).  bf16 cases draw
    table entries k / 64 and weights j / 16: every product and sum is then
    exact in f32 in any order, so the kernel and the plain version round
    the same sums to bf16 and 1e-4 holds the kernel's indexing and packing,
    not the order of its adds.  Also checks that :func:`instance` names the
    instance the C entry point runs.  Returns the largest error."""
    import numpy as np
    import torch

    from repro_torch.kernels.cuda_lib import library
    from repro_torch.kernels.embedding_bag import _DTYPES, embedding_bag, instance
    from repro_torch.kernels.ref import embedding_bag_ref

    lib = library().get()
    rng = np.random.default_rng(11)
    rows, names = [], set()
    for dtype, D, B, L, mode, weights, aligned in BAG_SWEEP:
        dt = getattr(torch, dtype)
        V = BAG_SWEEP_V
        if dtype == "bfloat16":
            tab = rng.integers(-64, 65, (V, D)) / 64.0
            w = rng.integers(0, 17, (B, L)) / 16.0
        else:
            tab = rng.standard_normal((V, D))
            w = rng.random((B, L))
        if weights == "zero":
            w[:] = 0.0
        ids = (rng.zipf(1.1, (B, L)) % V).astype(np.int32)
        if L:
            ids[0, 0], ids[0, -1] = V, -1
        table = torch.as_tensor(tab, dtype=dt, device=DEVICE)
        if not aligned:  # the same values one element past an aligned base
            table = torch.empty(V * D + 1, dtype=dt, device=DEVICE)[1:].view(V, D).copy_(table)
        idx = torch.as_tensor(ids, device=DEVICE)
        wt = None if weights == "none" else torch.as_tensor(w, dtype=torch.float32,
                                                           device=DEVICE)
        got = embedding_bag(table, idx, wt, mode=mode)
        want = embedding_bag_ref(table, idx, wt, mode=mode)
        torch.cuda.synchronize()
        inst = instance(table, idx)
        code = lib.embedding_bag_instance(table.data_ptr(), got.data_ptr(), D, _DTYPES[dt])
        if (code >> 8, code & 255) != inst[1:3]:
            fail(f"embedding_bag sweep {dtype} D={D}: the kernel runs {code >> 8}-byte loads "
                 f"by {code & 255} lanes, instance() says {inst}")
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        name = f"{dtype} D={D} B={B} L={L} {mode} weights {weights}" + (
            "" if aligned else ", base not 16-byte aligned")
        if not torch.allclose(got.float(), want.float(), **BAG_TOL):
            fail(f"embedding_bag sweep {name}: max abs err {err:.3g} outside 1e-4")
        rows.append({"case": name, "instance": inst, "max_abs_err": err})
        names.add(inst[1:3])
    report["embedding_bag_sweep"] = rows
    print(f"embedding_bag sweep: {len(rows)} cases within 1e-4 of the plain version (f32 and "
          f"bf16, D 16-256 and 33, L 0-64, partial last block, no weights, zero weights in "
          f"mean, a misaligned base; (bytes a load, lanes a row) {sorted(names)}), max abs err "
          f"{max(r['max_abs_err'] for r in rows):.3g}", flush=True)
    print(f"  ptxas: {ptxas_of(report, 'embedding_bag')}", flush=True)
    return max(r["max_abs_err"] for r in rows)


def store_phases(report: dict) -> list:
    """Phases 3-7 (slices A and B); returns their kernel table rows.  The
    store and its mirrors are freed when this returns."""
    store, inputs, built_delta, launches, rec = main_path(report)
    device_busy(store, report)
    rows = kernel_checks(store, rec, report)
    stream_launches, sweep_rec = streaming_phase(store, report)
    single = streaming_kernel_checks(sweep_rec, report)["global"]
    cpu_build_diff(inputs, built_delta, report)

    def row(name, line, launched, t):
        return {"name": name, "route": "cuda", "source": "src/repro_torch/csrc/dhd_spmv.cu",
                "replaces": f"src/repro/kernels/dhd_spmv.py:{line}", "launches": launched,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "host_loop_ms": t["host_loop_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": None}

    route, dhd = rows["route"], rows["dhd"]
    return [
        row("dhd_count", 159, launches["dhd_count"], dhd["count"]),
        row("dhd_flow", 173, launches["dhd_flow"], dhd["flow"]),
        {"name": "route_expand", "route": "cuda",
         "source": "src/repro_torch/csrc/route_expand.cu",
         "replaces": "src/repro/kernels/route_expand.py:48",
         "launches": launches["route_expand"], "max_abs_err": route["max_abs_err"],
         "ms": route["ms"], "host_loop_ms": route["host_loop_ms"],
         "plain_ms": route["plain_ms"], "bound_ms": route["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        row("dhd_count_single", 70, stream_launches["dhd_count_single"], single["count"]),
        row("dhd_flow_single", 82, stream_launches["dhd_flow_single"], single["flow"]),
    ]


# ---------------------------------------------------------------- slice D
# name, placement, routing: the paper pairings of benchmarks/common.py:84-89
# (Fig. 7; Random-3 is also Fig. 16's RP+RR), then Fig. 16's LP+RR
COMPETITORS = (("Random-3", "random", "random"), ("Top-3", "top", "random"),
               ("ADP", "adp", "greedy"), ("DCD", "dcd", "greedy"),
               ("LP+RR", "geolayer", "random"))
N_TEST = 40  # held-out test patterns (bench_online.py's fast size)
# bench_offline.py:24 and :70-81: each algorithm's supersteps (k-core: its
# peel rounds), the message size and the per-DC edge rate the BSP model prices
OFFLINE_ALGOS = {"pagerank": 15, "sssp": 10, "hits": 20, "lpa": 10, "core": None}
OFFLINE_MSG_BYTES, OFFLINE_EDGE_RATE = 192.0, 5e8
# make_benchmark_graph's "tw" family at scale 20 instead of 12: the largest
# R-MAT graph whose host reference and generation fit the run's time limit
RMAT_TW = dict(scale=20, edge_factor=16, a=0.57, b=0.19, c=0.19, seed=0, n_dcs=5)
ANALYTICS_TOL = dict(rtol=1e-4, atol=1e-7)


def held_out_patterns(g, env, history, n_test: int = N_TEST, seed: int = 0):
    """Test patterns drawn as ``benchmarks/common.py:50-69`` draws them:
    revisits of history patterns (each item kept with probability 0.8) plus
    the first quarter of a fresh pattern, made with the lane's k-hop
    settings."""
    import numpy as np

    from repro_torch.core.graph import build_csr
    from repro_torch.core.patterns import Pattern, generate_khop_patterns

    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    rng = np.random.default_rng(seed + 77)
    fresh = generate_khop_patterns(g, csr, n_test, hops=5, branch=2, seed=seed + 1000,
                                   n_dcs=env.n_dcs, n_hot_sources=64)
    test = []
    for i in range(n_test):
        base = history[int(rng.integers(0, len(history)))]
        keep = rng.random(len(base.items)) < 0.8
        tail = fresh[i].items[: max(2, len(fresh[i].items) // 4)]
        items = np.unique(np.concatenate([base.items[keep], tail]))
        test.append(Pattern(pid=10_000 + i, items=items, r_py=base.r_py,
                            w_py=base.w_py, eta=base.eta))
    return test


def mean_online_latency(store, patterns, seed: int = 0) -> float:
    """Mean modelled latency of ``serve_online`` over ``patterns``, each from
    an origin drawn as ``benchmarks/common.py:92-104`` draws it (65% home
    DC, 35% any)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lats = []
    for p in patterns:
        home = int(np.argmax(p.r_py))
        origin = home if rng.random() < 0.65 else int(rng.integers(0, store.env.n_dcs))
        lats.append(store.serve_online(p, origin).latency_s)
    return float(np.mean(lats))


def competitor_phase(report: dict, inputs):
    """Phase 12; returns the GeoLayer store it built (for phase 13) and the
    route-expansion and batched DHD rows checked on RP+SR's inputs, with
    RP+SR's launch counts."""
    import torch

    from repro_torch.core.placement import PlacementConfig
    from repro_torch.core.routing import pack_request_tiles, route_online_batch
    from repro_torch.core.store import GeoGraphStore
    from repro_torch.kernels import ops
    from repro_torch.kernels.cuda_lib import reset_launch_counters

    t_phase = time.perf_counter()
    g, env, wl = inputs
    test = held_out_patterns(g, env, wl.patterns)
    out = {"n_test": len(test), "stores": {}}

    def build(placement, routing, device=DEVICE):
        t = time.perf_counter()
        store = GeoGraphStore(g, env, wl, config=PlacementConfig(), placement=placement,
                              routing=routing, seed=0, device=device)
        if store.device.type == "cuda":
            torch.cuda.synchronize()
        return store, time.perf_counter() - t

    geo, geo_s = build("geolayer", "stepwise")
    geo_lat = mean_online_latency(geo, test)
    out["stores"]["GeoLayer"] = {"build_s": geo_s, "mean_latency_s": geo_lat, "normalised": 1.0}
    print(f"GeoLayer (LP+SR): built in {geo_s:.3f} s, mean online latency over "
          f"{len(test)} held-out patterns {geo_lat * 1e3:.3f} ms", flush=True)
    for name, placement, routing in COMPETITORS:
        store, s = build(placement, routing)
        lat = mean_online_latency(store, test)
        out["stores"][name] = {"placement": placement, "routing": routing, "build_s": s,
                               "mean_latency_s": lat, "normalised": lat / geo_lat,
                               "replicas": int(store.state.delta.sum())}
        print(f"{name} ({placement} placement, {routing} routing): built in {s:.3f} s, "
              f"mean online latency {lat * 1e3:.3f} ms, {lat / geo_lat:.3f}x GeoLayer's",
              flush=True)
        del store

    # RP+SR, the ablation's random placement under stepwise routing: its
    # serving takes route_expand and its maintain() the batched DHD pair on
    # replica classes the GeoLayer lane never makes
    mirror, mirror_s = build("random", "stepwise", device="cpu")
    reset_launch_counters()
    with DHDRecorder(ops) as rec:
        rp, rp_s = build("random", "stepwise")
        launches = {"build": launch_counts()}
        # the same held-out traffic into both demand planes (host routing)
        rp_lat = mean_online_latency(rp, test)
        if rp_lat != mean_online_latency(mirror, test):
            fail("RP+SR serve_online: the card store and its CPU mirror differ")
        served, probs = {}, {}
        for bs in BATCHES:
            reqs = request_stream(rp, bs, seed=bs)
            before = launch_counts()
            t = time.perf_counter()
            got = rp.serve_batch(reqs)
            serve_s = time.perf_counter() - t
            launches[f"serve_{bs}"] = {k: v - before[k] for k, v in launch_counts().items()}
            if not same_results(got, route_online_batch(rp.lg, rp.state, reqs, fast=False)):
                fail(f"RP+SR serve_batch({bs}) on the card differs from the numpy router")
            served[bs] = (reqs, got, serve_s)
            probs[bs] = pack_request_tiles(rp.lg, rp.state, reqs)
        rec.phase = "maintain"
        before = launch_counts()
        t = time.perf_counter()
        m = rp.maintain()
        torch.cuda.synchronize()
        maintain_s = time.perf_counter() - t
        launches["maintain"] = {k: v - before[k] for k, v in launch_counts().items()}
    total = launch_counts()
    for k, n in (("route_expand", sum(launches[f"serve_{b}"]["route_expand"] for b in BATCHES)),
                 ("dhd_count", launches["maintain"]["dhd_count"]),
                 ("dhd_flow", launches["maintain"]["dhd_flow"])):
        if n <= 0:
            fail(f"kernel {k} was not launched on RP+SR")
    for bs in BATCHES:
        reqs, got, _ = served[bs]
        if not same_results(got, mirror.serve_batch(reqs)):
            fail(f"RP+SR serve_batch({bs}): the card and its CPU mirror differ")
    m_cpu = mirror.maintain()
    rows_delta = int((rp.state.delta != mirror.state.delta).any(axis=1).sum())
    rows_route = int((rp.route_index.nearest != mirror.route_index.nearest).any(axis=1).sum())
    out["stores"]["RP+SR"] = {"placement": "random", "routing": "stepwise", "build_s": rp_s,
                              "mean_latency_s": rp_lat, "normalised": rp_lat / geo_lat}
    print(f"RP+SR: built on the card in {rp_s:.3f} s (CPU mirror {mirror_s:.3f} s), mean "
          f"online latency {rp_lat * 1e3:.3f} ms, {rp_lat / geo_lat:.3f}x GeoLayer's, "
          + ", ".join(f"serve_batch({bs}) {served[bs][2] * 1e3:.3f} ms" for bs in BATCHES)
          + f", each request-identical to the numpy router and the mirror; maintain() "
          f"{maintain_s:.3f} s evicted {m['evicted']} (mirror {m_cpu['evicted']}); "
          f"{rows_delta} replica rows and {rows_route} route rows differ from the mirror; "
          f"launches {total} (per step: {launches})", flush=True)
    if m != m_cpu or rows_delta or rows_route:
        fail("RP+SR maintain() on the card differs from its CPU mirror")

    busy = {}
    reqs = served[BATCHES[-1]][0]
    for name, fn, reps in (
        ("serve_batch_1024", lambda: rp.serve_batch(reqs, observe=False), 5),
        ("maintain_no_evict", lambda: rp.maintain(evict=False), 2),
    ):
        fn()
        torch.cuda.synchronize()
        wall_ms, busy_ms, by_kind, _ = profiled(fn, reps)
        busy[name] = {"device_ms": busy_ms, "wall_ms_profiled": wall_ms,
                      "device_share": busy_ms / wall_ms, "by_kind_ms": by_kind}
        print(f"RP+SR {name}: device busy {busy_ms:.4f} ms of {wall_ms:.3f} ms (profiled "
              f"wall), share {busy_ms / wall_ms:.4f}", flush=True)

    routes = []
    for bs in BATCHES:
        r = check_route_expand(f"RP+SR batch {bs}", probs[bs], timed=True)
        routes.append(r)
        print(f"route_expand {r['case']} {r['shape']} (R, K, D, L): slots_instance "
              f"{r['slots_instance']}, exact, max abs err {r['max_abs_err']:.3g}, kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms",
              flush=True)
    key = ("maintain", env.n_dcs, False)
    if key not in rec.kept:
        fail("RP+SR maintain() ran no DHD step over the per-DC heat fields")
    heat, cols, vals, q, params = rec.kept[key]
    dhd = check_dhd(f"RP+SR maintain, call {rec.calls[key]}", heat, cols, vals, q, params)
    print(f"dhd {dhd['case']} {dhd['shape']}: count kernel {dhd['count']['ms']:.4f} ms "
          f"(bound {dhd['count']['bound_ms']:.5f}), flow kernel {dhd['flow']['ms']:.4f} ms "
          f"(bound {dhd['flow']['bound_ms']:.5f}), counts equal, flows within atol 1e-5 / "
          f"rtol 1e-4, max abs err {dhd['flow']['max_abs_err']:.3g}", flush=True)
    rp_launches = {"route_expand": sum(launches[f"serve_{b}"]["route_expand"] for b in BATCHES),
                   "dhd_count": launches["maintain"]["dhd_count"],
                   "dhd_flow": launches["maintain"]["dhd_flow"]}
    out["rp_sr"] = {
        "build_s": rp_s, "mirror_build_s": mirror_s, "maintain_s": maintain_s,
        "serve_s": {bs: served[bs][2] for bs in BATCHES}, "evicted": int(m["evicted"]),
        "launches": total, "launches_by_step": launches, "device_busy": busy,
        "route_expand_checks": routes, "dhd_check": dhd,
        "max_replicas_per_item": int(rp.state.delta.sum(axis=1).max()),
    }
    del rp, mirror
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 12 (competitor stores) wall {out['wall_s']:.1f} s", flush=True)
    report["competitors"] = out
    return geo, rp_launches


def geo_layout(store, plan):
    """GeoLayer's offline layout as ``benchmarks/bench_offline.py:27-55``
    picks it: the consolidated plan is adopted only where the BSP model
    prices it below executing in place (or it trades time for WAN bytes);
    returns (vertex sites, assembly bytes charged)."""
    from repro_torch.core import analytics

    site = plan.item_site[: store.g.n_nodes].copy()
    site[site < 0] = store.g.partition[site < 0]
    inplace = store.g.partition.astype("int64")
    c_cons = analytics.simulate_execution(
        store.env, store.g, site, 15, msg_bytes=OFFLINE_MSG_BYTES,
        edge_rate=OFFLINE_EDGE_RATE, assembly_bytes=plan.wan_bytes)
    c_inpl = analytics.simulate_execution(
        store.env, store.g, inplace, 15, msg_bytes=OFFLINE_MSG_BYTES,
        edge_rate=OFFLINE_EDGE_RATE)
    # the reference's three branches reduce to two: its last is reached
    # only when the consolidated layout is no slower
    if c_cons.time_s > c_inpl.time_s and c_cons.wan_bytes >= c_inpl.wan_bytes:
        return inplace, 0.0
    return site, plan.wan_bytes


def offline_layouts(store, plan) -> tuple:
    """GeoLayer's layout (with the assembly bytes it carries) and the
    RAGraph, RAGraph+ and GrapH layouts of ``store``'s graph (traffic: each
    vertex's read rate summed over DCs), each with its host seconds."""
    from repro_torch.core.baselines import (
        layout_graph_h,
        layout_ragraph,
        layout_ragraph_plus,
    )

    g, env = store.g, store.env
    traffic = store.workload.r_xy[: g.n_nodes].sum(axis=1)
    t = time.perf_counter()
    site, assembly = geo_layout(store, plan)
    layouts, secs = {"geolayer": site}, {"geolayer": time.perf_counter() - t}
    for name, fn in (("ragraph", lambda: layout_ragraph(g, env)),
                     ("ragraph+", lambda: layout_ragraph_plus(g, env, traffic)),
                     ("graph_h", lambda: layout_graph_h(g, env, traffic))):
        t = time.perf_counter()
        layouts[name] = fn()
        secs[name] = time.perf_counter() - t
    return layouts, secs, assembly


def offline_phase(report: dict, geo) -> None:
    """Phase 13: offline routing and the competitor layouts on the lane
    store, against a CPU mirror; prices each layout under the BSP model."""
    import numpy as np

    from repro_torch.convert import store_arrays, store_from_numpy
    from repro_torch.core import analytics

    t_phase = time.perf_counter()
    mirror = store_from_numpy(store_arrays(geo), device="cpu")
    req = np.arange(geo.g.n_nodes)
    plans = {}
    for name, store in (("card", geo), ("cpu", mirror)):
        t = time.perf_counter()
        plans[name] = store.plan_offline(req, n_iters=15, msg_bytes=OFFLINE_MSG_BYTES)
        plans[name + "_s"] = time.perf_counter() - t
    plan, plan_cpu = plans["card"], plans["cpu"]
    for f in ("sites", "item_site", "migrated", "excluded"):
        if not np.array_equal(getattr(plan, f), getattr(plan_cpu, f)):
            fail(f"plan_offline: {f} differs from the CPU mirror's")
    if plan.wan_bytes != plan_cpu.wan_bytes:
        fail("plan_offline: wan_bytes differs from the CPU mirror's")
    wall_ms, busy_ms, _, _ = profiled(
        lambda: geo.plan_offline(req, n_iters=15, msg_bytes=OFFLINE_MSG_BYTES))
    print(f"plan_offline({len(req)} vertices): {plans['card_s']:.3f} s, sites "
          f"{plan.sites.tolist()}, excluded {plan.excluded.tolist()}, {len(plan.migrated)} "
          f"migrated, assembly {plan.wan_bytes / 1e6:.3f} MB; equal to the CPU mirror's; "
          f"device busy {busy_ms:.4f} ms of {wall_ms:.1f} ms", flush=True)
    layouts, secs, assembly = offline_layouts(geo, plan)
    layouts_cpu, _, assembly_cpu = offline_layouts(mirror, plan_cpu)
    for name, site in layouts.items():
        if not np.array_equal(site, layouts_cpu[name]):
            fail(f"offline layout {name} differs from the CPU mirror's")
    if assembly != assembly_cpu:
        fail("GeoLayer's assembly bytes differ from the CPU mirror's")
    print("layouts (host s): " + ", ".join(
        f"{k} {v:.3f} s, {float((layouts[k] != geo.g.partition).mean()):.4f} migrated"
        for k, v in secs.items()) + "; each equal to the CPU mirror's", flush=True)
    g, env = geo.g, geo.env
    priced = {}
    for algo, iters in OFFLINE_ALGOS.items():
        if iters is None:
            _, iters = analytics.core_decomposition(g.n_nodes, g.src, g.dst)
        stats = {}
        for name, site in layouts.items():
            ex = analytics.simulate_execution(
                env, g, site, n_iters=iters, msg_bytes=OFFLINE_MSG_BYTES,
                edge_rate=OFFLINE_EDGE_RATE,
                assembly_bytes=assembly if name == "geolayer" else 0.0)
            stats[name] = {"time_s": ex.time_s, "wan_bytes": ex.wan_bytes,
                           "sites": ex.n_sites, "cut_edges": ex.cut_edges}
        base = stats["ragraph"]
        for s in stats.values():
            s["speedup_vs_ragraph"] = base["time_s"] / s["time_s"]
            s["wan_vs_ragraph"] = s["wan_bytes"] / base["wan_bytes"] if base["wan_bytes"] else None
        priced[algo] = {"iters": int(iters), "layouts": stats}
        print(f"{algo} ({iters} supersteps): " + "; ".join(
            f"{k} {s['time_s']:.4f} s, {s['wan_bytes'] / 1e6:.2f} MB WAN, "
            f"{s['speedup_vs_ragraph']:.3f}x RAGraph" for k, s in stats.items()), flush=True)
    wall = time.perf_counter() - t_phase
    report["offline"] = {
        "plan_s": plans["card_s"], "plan_cpu_s": plans["cpu_s"],
        "sites": plan.sites.tolist(), "excluded": plan.excluded.tolist(),
        "migrated": int(len(plan.migrated)), "assembly_bytes": plan.wan_bytes,
        "plan_device_busy_ms": busy_ms, "plan_wall_ms_profiled": wall_ms,
        "layout_s": secs, "priced": priced, "wall_s": wall,
    }
    print(f"phase 13 (offline routing and layouts) wall {wall:.1f} s", flush=True)


def analytics_bytes(algo: str, n: int, m: int, index_bytes: int) -> int:
    """Bytes one iteration must move at the least: each index array read
    once a pass, vertex arrays read and written once (f32 or int32).
    PageRank: src, dst, rank and out-degree in, rank out.  SSSP: src, dst,
    weights, distances in and out.  HITS: two dependent passes (each pass's
    norm divides before the next), each reading src and dst.  LPA: one pass
    gives both minima, labels in and out."""
    per_pass = 2 * index_bytes * m
    return {"pagerank": per_pass + 12 * n, "sssp": per_pass + 4 * m + 8 * n,
            "hits": 2 * per_pass + 16 * n, "lpa": per_pass + 8 * n}[algo]


def run_analytics(label: str, g) -> dict:
    """PageRank (15), SSSP (10, weights ``edge_size``, source 0), HITS (20)
    and LPA (10) over ``g`` on the card and on the host; SSSP and LPA must
    be equal, PageRank and HITS within ``ANALYTICS_TOL``."""
    import torch

    from repro_torch.core import analytics

    n, m = int(g.n_nodes), int(len(g.src))
    algos = {
        "pagerank": (15, lambda s, d, w, dev: analytics.pagerank(s, d, n, 15, device=dev)),
        "sssp": (10, lambda s, d, w, dev: analytics.sssp(s, d, w, 0, n, 10, device=dev)),
        "hits": (20, lambda s, d, w, dev: analytics.hits(s, d, n, 20, device=dev)),
        "lpa": (10, lambda s, d, w, dev: analytics.label_propagation(s, d, n, 10, device=dev)),
    }
    on = {dev: (torch.as_tensor(g.src).to(dev, torch.int64),
                torch.as_tensor(g.dst).to(dev, torch.int64),
                torch.as_tensor(g.edge_size).to(dev, torch.float32))
          for dev in (DEVICE, "cpu")}
    rows = {}
    for algo, (iters, fn) in algos.items():
        def run(dev):
            return fn(*on[dev], dev)

        run(DEVICE)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = run(DEVICE)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        wall_ms, busy_ms, by_kind, _ = profiled(lambda: run(DEVICE))
        t = time.perf_counter()
        want = run("cpu")
        cpu_s = time.perf_counter() - t
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = 0.0
        for a, b in pairs:
            a = a.cpu()
            if algo in ("sssp", "lpa"):
                if not torch.equal(a, b):
                    fail(f"{algo} on {label}: the card's result is not equal to the host's")
            elif not torch.allclose(a, b, **ANALYTICS_TOL):
                fail(f"{algo} on {label}: the card's result is outside rtol 1e-4 / atol 1e-7 "
                     f"of the host's")
            finite = torch.isfinite(b)
            if bool(finite.any()):
                err = max(err, float((a[finite].double() - b[finite].double()).abs().max()))
        bound = {ib: analytics_bytes(algo, n, m, ib) / HBM_BYTES_PER_S * 1e3 for ib in (4, 8)}
        rows[algo] = {
            "iters": iters, "ms": ms, "ms_per_iter": ms / iters,
            "edges_per_s": m * iters / (ms / 1e3), "bound_ms_per_iter_i32": bound[4],
            "bound_ms_per_iter_i64": bound[8], "device_busy_ms": busy_ms,
            "wall_ms_profiled": wall_ms, "device_share": busy_ms / wall_ms,
            "by_kind_ms": by_kind, "cpu_s": cpu_s, "max_abs_err": err,
        }
        r = rows[algo]
        print(f"{algo} on {label} ({iters} iterations): {r['ms_per_iter']:.4f} ms an "
              f"iteration, {r['edges_per_s'] / 1e9:.3f} G edges/s, bound {bound[4]:.4f} ms "
              f"(int32 indices) / {bound[8]:.4f} ms (int64); device busy share "
              f"{r['device_share']:.3f} under the profiler; host {cpu_s:.3f} s; "
              f"{'equal' if algo in ('sssp', 'lpa') else 'within rtol 1e-4'} "
              f"(max abs err {err:.3g})", flush=True)
    del on
    return rows


def analytics_phase(report: dict, lane_graph) -> None:
    """Phase 14: the analytics on the lane graph (with k-core on the host)
    and on an R-MAT graph of the "tw" family at scale 20."""
    import numpy as np

    from repro_torch.core.analytics import core_decomposition
    from repro_torch.data.synthetic import rmat_graph

    t_phase = time.perf_counter()
    out = {}
    g = lane_graph
    t = time.perf_counter()
    core, rounds = core_decomposition(g.n_nodes, g.src, g.dst)
    core_s = time.perf_counter() - t
    print(f"lane graph: {g.n_nodes} vertices, {len(g.src)} edges; core_decomposition on "
          f"the host {core_s:.3f} s, max core {int(core.max())}, {rounds} peel rounds",
          flush=True)
    out["lane"] = {"n": int(g.n_nodes), "m": int(len(g.src)), "core_s": core_s,
                   "max_core": int(core.max()), "core_rounds": int(rounds),
                   "algos": run_analytics("the lane graph", g)}
    t = time.perf_counter()
    big = rmat_graph(**RMAT_TW)
    gen_s = time.perf_counter() - t
    indeg = int(np.bincount(big.dst, minlength=big.n_nodes).max())
    print(f"rmat_graph({RMAT_TW}): {big.n_nodes} vertices, {len(big.src)} edges, max "
          f"in-degree {indeg}, generated on the host in {gen_s:.1f} s", flush=True)
    out["rmat_tw_20"] = {"n": int(big.n_nodes), "m": int(len(big.src)), "gen_s": gen_s,
                         "max_in_degree": indeg,
                         "algos": run_analytics(f"R-MAT tw scale {RMAT_TW['scale']}", big)}
    out["wall_s"] = time.perf_counter() - t_phase
    report["analytics"] = out
    print(f"phase 14 (graph analytics) wall {out['wall_s']:.1f} s", flush=True)


def kernel_name(mangled: str) -> str:
    """``flash_attn_wgmma_kernel<2>`` from its Itanium-mangled name: the last
    component of the nested name, with its template arguments (integers,
    booleans, ``float`` or named types)."""
    import re

    pos, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        m = re.match(r"\d+", mangled[pos:])
        pos += m.end()
        name = mangled[pos: pos + int(m.group())]
        pos += int(m.group())
    if not mangled.startswith("I", pos):
        return name
    rest, args = mangled[pos + 1:], []
    while rest and not rest.startswith("E"):
        m = re.match(r"Li(\d+)E|Lb([01])E|(f)|(\d+)", rest)
        if m is None:
            break
        if m.group(4):  # a named type: its length, then its name
            size = int(m.group(4))
            args.append(rest[m.end(): m.end() + size])
            rest = rest[m.end() + size:]
            continue
        args.append(m.group(1) or ("float" if m.group(3) else ("false", "true")[int(m.group(2))]))
        rest = rest[m.end():]
    return f"{name}<{', '.join(args)}>"


def ptxas_report(log: str) -> dict:
    """Registers, spill bytes and warnings of each kernel from ``nvcc
    -Xptxas -v``, keyed by :func:`kernel_name`."""
    import re

    out: dict = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name]["spill_bytes"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
        if "warning" in line:  # a warning may name its kernel
            m = re.search(r"'(_Z\w+)'", line)
            key = kernel_name(m.group(1)) if m else name or "(build)"
            out.setdefault(key, {}).setdefault("warnings", []).append(line.strip())
    return out


def main() -> None:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels.cuda_lib import library
    except ImportError as e:
        fail(f"the repro_torch package is missing next to chip_smoke.py ({e})")
    card = gpu_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)

    lib = library()
    t = time.perf_counter()
    lib.get()
    print(f"kernels built in {time.perf_counter() - t:.2f} s -> {lib.path.name}", flush=True)
    ptxas = ptxas_report(lib.build_log)
    for fn, info in ptxas.items():
        print(f"  ptxas: {fn}: {info}", flush=True)

    floor_ms = launch_floor_ms()
    clocks = gpu_query("clocks.sm,clocks.max.sm")
    print(f"launch floor (graph-replayed launch of no work): {floor_ms:.5f} ms; SM clock, "
          f"max SM clock: {clocks}", flush=True)
    report: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                    "build_s": lib.build_s, "ptxas": ptxas, "launch_floor_ms": floor_ms,
                    "sm_clocks": clocks}
    table = store_phases(report)
    gc.collect()
    torch.cuda.empty_cache()
    lm = lm_serving_phase(report)
    lm_end_to_end_check(lm, report)
    table.append(attention_kernel_checks(lm, report))
    del lm
    attention_sweep(report)
    gc.collect()
    torch.cuda.empty_cache()
    table.append(bag_phase(report))
    gc.collect()
    torch.cuda.empty_cache()
    inputs = build_inputs()
    geo, rp_launches = competitor_phase(report, inputs)
    for r in table:
        if r["name"] in rp_launches:
            r["launches_by_path"] = {"main": r["launches"], "rp_sr": rp_launches[r["name"]]}
    offline_phase(report, geo)
    del geo
    analytics_phase(report, inputs[0])

    for r in table:
        r["launch_floor_ms"] = floor_ms
    report["kernels"] = table
    report["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=float))
    print(f"chip_smoke: every phase passed in {report['total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
