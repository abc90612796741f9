#!/usr/bin/env python3
"""Time the port's route-expansion and embedding-bag kernels of two
checkouts on the same inputs, in turns.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 tools/kernel_ab.py [--base DIR ...] [--only route_expand|embedding_bag]

Each ``DIR`` is another checkout of the repository (an earlier commit
unpacked with ``git archive``).  Each checkout's
``src/repro_torch/csrc/{route_expand,embedding_bag}.cu`` is compiled with
``nvcc`` (the port's own flags, one process per checkout, all started
together) into ``build/kernel_ab/`` and loaded with ``ctypes``.  The
inputs are those ``chip_smoke.py`` records:

* route expansion: the inputs of the store batches of 64, 256 and 1024
  requests that launch the ragged kernel in this checkout's phase 3 (store
  build, serving, ``maintain``), recorded on the card: item ids over the
  store's route tables and their byte shift, as this checkout launches
  them; the five sub-batches of phase 20's recorded drain (up to 329,472
  items) over that cell's tables; phase 20's sweep (reads of up to 40,000
  items, 31 DCs).  A build whose id-keyed entry still folds f32 bytes,
  latencies and WAN bytes (the commits before the int64 sums) takes RTT
  and 1/bandwidth tables in place of the shift;
* embedding bags: phase 11's BST table (2^22 x 32, f32) and Zipf ids, 20 a
  bag, at 512 and 262,144 bags, in sum and mean.

Every build is held against the port's plain version first (route outputs
``served``, ``layers_used`` and ``miss_after`` equal, and the int64 sums,
served-DC masks and unresolved counts, or an f32 build's bytes within
1e-5; bags within 1e-4); then each kernel is timed by CUDA-graph replay,
the builds' graphs replayed in turns (base, this, this, base).  On the
store batches this checkout's route kernel is also timed with no layers above 0 (its loads,
fold and stores without the greedy walk) and over the rows (ids ``0 ..
N - 1``), in turns; its bag
kernel on two control id sets (a hot 4 MB set, uniform ids).  Prints ptxas' registers
and spills of each build's kernels and, as its last line, one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (timers, inputs, tolerances)
from tools.dhd_ab import build, in_turns  # noqa: E402

SOURCES = ("route_expand.cu", "embedding_bag.cu")
ENTRIES = ("embedding_bag_fwd",)
IDS_ENTRY = "route_expand_ragged_ids_launch"
# the id-keyed entry of the builds that folded f32 bytes on the card: (ids,
# bits, sizes, offsets, origin, order, n_long, comp, rtt, ibw, served,
# bytes_rd, layers_used, miss_after, straggler, wan, R, D, L, stream)
F32_FOLD_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) + (ctypes.c_void_p,) * 9
                     + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))


def route_entry(lib, checkout: pathlib.Path):
    """``(launch, sums)``: a build's ragged route entry, and whether it
    writes int64 sums (this form) or, as the builds before it, f32 bytes,
    latencies and WAN bytes; told apart by the checkout's source."""
    from repro_torch.kernels import cuda_lib

    src = (checkout / "src" / "repro_torch" / "csrc" / "route_expand.cu").read_text()
    sums = "long long* units" in src
    fn = getattr(lib, IDS_ENTRY)
    fn.argtypes = list(cuda_lib._SIGNATURES[IDS_ENTRY] if sums else F32_FOLD_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn, sums


def f32_fold_buffers(N: int, R: int, D: int, L: int):
    """The outputs of a build that folds f32 bytes on the card: ``(served
    [N] i8, bytes_rd [R, D] f32, layers_used [R] i32, miss_after [R, L+1]
    i32, straggler [R] f32, wan [R] f32)``."""
    import torch

    def e(shape, dt):
        return torch.empty(shape, dtype=dt, device=smoke.DEVICE)

    return (e(N, torch.int8), e((R, D), torch.float32), e(R, torch.int32),
            e((R, L + 1), torch.int32), e(R, torch.float32), e(R, torch.float32))


def route_problems():
    """``(label, (ids, table_bits, table_sizes, offsets, origin, comp,
    shift))`` as ``chip_smoke.check_ragged`` takes them: the store batches
    phase 3 launches, the five sub-batches of phase 20's drain (over the
    cell's route tables) and phase 20's sweep (rows as tables over ids
    ``0 .. N - 1``)."""
    import numpy as np

    from repro_torch.core.route_tables import fold_shift

    store, *_, rec = smoke.main_path({})
    for bs, prob in sorted(rec.routes.items()):
        yield f"main batch {bs}", prob
    del store
    store, _, _, _, subs = smoke.ragged_drain()
    for o, sub in subs.items():
        yield f"drain origin {o}", smoke._ids_of(store, sub)
    del store
    for i, (name, lens, D, L, p_rep, ties) in enumerate(smoke.RAGGED_SWEEP):
        rows = smoke.flat_route_problem(np.random.default_rng(2000 + i), lens, D, L, p_rep, ties)
        yield name, (np.arange(len(rows[0]), dtype=np.int32), *rows, fold_shift(rows[1]))


def route_cases(builds: dict, checkouts: dict) -> list:
    import numpy as np
    import torch

    from repro_torch.kernels.cuda_lib import stream_ptr
    from repro_torch.kernels.ref import route_expand_ragged_ids_ref
    from repro_torch.kernels.route_expand import ragged_buffers, ragged_order

    rows = []
    for case, prob in route_problems():
        *arrays, shift = prob
        ids_args = [torch.as_tensor(np.ascontiguousarray(x), device=smoke.DEVICE)
                    for x in arrays]
        ids, tb, tz, offsets, origin, comp = arrays
        N, R, D, L = len(ids), len(origin), comp.shape[1], comp.shape[0] - 1
        # an f32 build's latency fold reads these; nothing checks its output
        rtt_ibw = [torch.zeros((D, D), device=smoke.DEVICE) for _ in range(2)]
        gathered = (tb[ids], tz[ids])  # the rows the ids stand for
        row_args = [torch.as_tensor(x, device=smoke.DEVICE) for x in gathered] + ids_args[3:]
        order, n_long = ragged_order(np.diff(offsets))
        order_t = torch.as_tensor(order, device=smoke.DEVICE)
        dev = order_t.device
        want = route_expand_ragged_ids_ref(*ids_args, shift)
        fns, keep = {}, []  # keep: outputs the launches write, alive while timed

        def ptrs_of(args, sums, bufs):
            tail = [shift] if sums else [t.data_ptr() for t in rtt_ibw]
            return ([a.data_ptr() for a in args[:5]] + [order_t.data_ptr(), n_long]
                    + [args[5].data_ptr()] + tail + [b.data_ptr() for b in bufs])

        for label, (lib, _) in builds.items():
            fn, sums = route_entry(lib, checkouts[label])
            bufs = ragged_buffers(N, R, D, L, smoke.DEVICE)[1:] if sums else f32_fold_buffers(
                N, R, D, L)
            keep.append(bufs)
            ptrs = ptrs_of(ids_args, sums, bufs)

            def launch(fn=fn, ptrs=ptrs):
                fn(*ptrs, R, D, L, stream_ptr(dev))

            launch()
            torch.cuda.synchronize()
            # the plain version's outputs the build writes: every one, or
            # (an f32 build) the picks, layers and missing counts exact and
            # its bytes within 1e-5 of the exact sums
            exact = (0, 1, 2, 3, 4, 5) if sums else (0, 2, 3)
            bad = [i for i in exact if not torch.equal(bufs[i], want[i])]
            if not sums and not torch.allclose(bufs[1].double(), want[1].double() * 2.0 ** -shift,
                                               rtol=1e-5, atol=1e-4):
                bad.append(1)
            if bad:
                smoke.fail(f"{label} route_expand_ragged, {case}: outputs {bad} differ from the "
                           "plain version")
            fns[label] = launch
        row = {"kernel": "route_expand_ragged", "case": case, "reads": R, "items": N, "D": D,
               "L": L, **{f"ms_{x}": t for x, t in in_turns(fns).items()}}
        if case.startswith("main"):
            fn, _ = route_entry(builds["this"][0], ROOT)
            arange = torch.arange(N, dtype=torch.int32, device=smoke.DEVICE)
            variant_ptrs = {}
            for name, args, layers in (("as recorded", ids_args, L),
                                       ("no walk (L = 0)", ids_args, 0),
                                       ("over the rows", [arange] + row_args, L)):
                bufs = ragged_buffers(N, R, D, L, smoke.DEVICE)[1:]
                keep.append((args, bufs))  # written by the launches below while they are timed
                variant_ptrs[name] = (ptrs_of(args, True, bufs), layers)
            # the same launch with no layers above 0 (every load, the local
            # pass, the fold and the stores, but no greedy walk), and over the
            # rows its ids stand for, read where they lie
            row["ms_this_variants"] = in_turns({
                name: (lambda p=p, layers=layers: fn(*p, R, D, layers, stream_ptr(dev)))
                for name, (p, layers) in variant_ptrs.items()
            })
        rows.append(row)
        print(json.dumps(row), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def bag_cases(builds: dict) -> list:
    import torch

    from repro_torch.kernels.cuda_lib import stream_ptr
    from repro_torch.kernels.embedding_bag import instance
    from repro_torch.kernels.ref import embedding_bag_ref

    table, bags = smoke.bag_inputs()
    rows = []
    for B, ids, w in bags:
        for mode in ("sum", "mean"):
            want = embedding_bag_ref(table, ids, w, mode=mode)
            fns, keep = {}, []  # keep: outputs the launches write, alive while timed
            for label, (lib, _) in builds.items():
                out = torch.empty_like(want)
                keep.append(out)
                args = (table.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(), B,
                        smoke.BAG_L, smoke.BAG_V, smoke.BAG_D, int(mode == "mean"), 0)

                def launch(lib=lib, args=args):
                    lib.embedding_bag_fwd(*args, stream_ptr(table.device))

                launch()
                torch.cuda.synchronize()
                if not torch.allclose(out, want, **smoke.BAG_TOL):
                    smoke.fail(f"{label} embedding_bag, B={B} {mode}: outside 1e-4 of the "
                               "plain version")
                fns[label] = launch
            row = {"kernel": "embedding_bag", "B": B, "mode": mode,
                   "instance": instance(table, ids),
                   **{f"ms_{x}": t for x, t in in_turns(fns).items()}}
            if B == smoke.BAG_BATCHES[-1]:
                row["ms_this_by_ids"] = id_controls(builds["this"][0], table, ids, w, mode)
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def id_controls(lib, table, ids, w, mode: str) -> dict:
    """This checkout's bag kernel at the recorded shape on three id sets, in
    turns: the recorded Zipf ids; ids uniform over the first 32,768 rows
    (4 MB: every gather after the first hits L2); ids uniform over the whole
    table (537 MB: nearly every gather misses L2).  The controls bracket
    what L2 hits and HBM gathers cost this kernel."""
    import torch

    from repro_torch.kernels.cuda_lib import stream_ptr

    gen = torch.Generator(device=smoke.DEVICE).manual_seed(3)
    sets = {
        "zipf": ids,
        "hot 4 MB": torch.randint(0, 1 << 15, ids.shape, generator=gen, device=smoke.DEVICE,
                                  dtype=torch.int32),
        "uniform": torch.randint(0, smoke.BAG_V, ids.shape, generator=gen,
                                 device=smoke.DEVICE, dtype=torch.int32),
    }
    B = ids.shape[0]
    outs = {k: torch.empty((B, smoke.BAG_D), device=smoke.DEVICE) for k in sets}
    fns = {
        k: (lambda k=k: lib.embedding_bag_fwd(
            table.data_ptr(), sets[k].data_ptr(), w.data_ptr(), outs[k].data_ptr(), B,
            smoke.BAG_L, smoke.BAG_V, smoke.BAG_D, int(mode == "mean"), 0,
            stream_ptr(table.device)))
        for k in sets
    }
    return in_turns(fns)


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=pathlib.Path, action="append", default=[],
                    help="another checkout to time against (repeatable)")
    ap.add_argument("--only", choices=("route_expand", "embedding_bag"),
                    help="time one kernel only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is False: kernel_ab needs a CUDA card")
    card = smoke.gpu_line()
    print(card, flush=True)
    checkouts = {**{d.resolve().name: d.resolve() for d in args.base}, "this": ROOT}
    builds = build(checkouts, SOURCES, ENTRIES, "kernel_ab")
    for label, (_, ptxas) in builds.items():
        for name, info in ptxas.items():
            print(f"  ptxas {label}: {name}: {info}", flush=True)
    rows = []
    if args.only in (None, "route_expand"):
        rows += route_cases(builds, checkouts)
    if args.only in (None, "embedding_bag"):
        rows += bag_cases(builds)
    print(card, flush=True)
    print(json.dumps({"kernel_ab": rows, "card": card}), flush=True)


if __name__ == "__main__":
    main()
