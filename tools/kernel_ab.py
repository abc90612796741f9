#!/usr/bin/env python3
"""Time the port's route-expansion and embedding-bag kernels of two
checkouts on the same inputs, in turns.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 tools/kernel_ab.py [--base DIR ...] [--only route_expand|embedding_bag]

Each ``DIR`` is another checkout of the repository (an earlier commit
unpacked with ``git archive``).  Each checkout's
``src/repro_torch/csrc/{route_expand,embedding_bag}.cu`` is compiled with
``nvcc`` (the port's own flags, one process per checkout, all started
together) into ``build/kernel_ab/`` and loaded with ``ctypes``; all expose
the same C entry points.  The inputs are those ``chip_smoke.py`` records:

* route expansion: the flat inputs of the store batches of 64, 256 and 1024
  requests that launch the ragged kernel in this checkout's phase 3 (store
  build, serving, ``maintain``), recorded on the card;
* embedding bags: phase 11's BST table (2^22 x 32, f32) and Zipf ids, 20 a
  bag, at 512 and 262,144 bags, in sum and mean.

Every build is held against the port's plain version first (route outputs
``served``, ``layers_used`` and ``miss_after`` equal, bags within 1e-4);
then each kernel is timed by CUDA-graph replay, the builds' graphs replayed
in turns (base, this, this, base).  This checkout's route kernel is also
timed with no layers above 0 (its loads, fold and stores without the
greedy walk), in turns; its bag kernel
on two control id sets (a hot 4 MB set, uniform ids).  Prints ptxas' registers
and spills of each build's kernels and, as its last line, one JSON object.
"""
from __future__ import annotations

import argparse
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
ENTRIES = ("route_expand_ragged_launch", "embedding_bag_fwd")


def route_cases(builds: dict) -> list:
    import numpy as np
    import torch

    from repro_torch.kernels.cuda_lib import stream_ptr
    from repro_torch.kernels.ref import route_expand_ragged_ref
    from repro_torch.kernels.route_expand import ragged_buffers, ragged_order

    store, *_, rec = smoke.main_path({})
    rows = []
    for bs, prob in sorted(rec.routes.items()):
        args = [torch.as_tensor(np.ascontiguousarray(x), device=smoke.DEVICE) for x in prob]
        bits, _, offsets, origin, comp = prob[:5]
        N, R, D, L = len(bits), len(origin), comp.shape[1], comp.shape[0] - 1
        order, n_long = ragged_order(np.diff(offsets))
        order_t = torch.as_tensor(order, device=smoke.DEVICE)
        want = route_expand_ragged_ref(*args)
        fns, keep = {}, []  # keep: outputs the launches write, alive while timed

        def ptrs_of(bufs):
            return ([a.data_ptr() for a in args[:4]] + [order_t.data_ptr(), n_long]
                    + [a.data_ptr() for a in args[4:]] + [b.data_ptr() for b in bufs[2:]])

        for label, (lib, _) in builds.items():
            bufs = ragged_buffers(N, R, D, L, smoke.DEVICE)
            keep.append(bufs)

            def launch(lib=lib, ptrs=ptrs_of(bufs)):
                lib.route_expand_ragged_launch(*ptrs, R, D, L, stream_ptr(args[0].device))

            launch()
            torch.cuda.synchronize()
            for i, what in ((2, "served"), (4, "layers_used"), (5, "miss_after")):
                if not torch.equal(bufs[i], want[i - 2]):
                    smoke.fail(f"{label} route_expand_ragged, batch {bs}: {what} differs from "
                               "the plain version")
            fns[label] = launch
        row = {"kernel": "route_expand_ragged", "batch": bs, "reads": R, "items": N, "D": D,
               "L": L, **{f"ms_{x}": t for x, t in in_turns(fns).items()}}
        lib = builds["this"][0]
        ptrs = ptrs_of(ragged_buffers(N, R, D, L, smoke.DEVICE))
        # the same launch with no layers above 0: every load, the local
        # pass, the fold and the stores, but no greedy walk
        row["ms_this_variants"] = in_turns({
            "as recorded": lambda: lib.route_expand_ragged_launch(
                *ptrs, R, D, L, stream_ptr(args[0].device)),
            "no walk (L = 0)": lambda: lib.route_expand_ragged_launch(
                *ptrs, R, D, 0, stream_ptr(args[0].device)),
        })
        rows.append(row)
        print(json.dumps(row), flush=True)
    del store
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
    builds = build({**{d.resolve().name: d.resolve() for d in args.base}, "this": ROOT},
                   SOURCES, ENTRIES, "kernel_ab")
    for label, (_, ptxas) in builds.items():
        for name, info in ptxas.items():
            print(f"  ptxas {label}: {name}: {info}", flush=True)
    rows = []
    if args.only in (None, "route_expand"):
        rows += route_cases(builds)
    if args.only in (None, "embedding_bag"):
        rows += bag_cases(builds)
    print(card, flush=True)
    print(json.dumps({"kernel_ab": rows, "card": card}), flush=True)


if __name__ == "__main__":
    main()
