#!/usr/bin/env python3
"""Time the port's DHD kernels of two checkouts on the same inputs, in turns.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 tools/dhd_ab.py [--base DIR ...]

Each ``DIR`` is another checkout of the repository (an earlier commit
unpacked with ``git archive``).  Each checkout's
``src/repro_torch/csrc/dhd_spmv.cu`` is compiled with ``nvcc`` (the port's
own flags, one process per checkout, all started together) into
``build/dhd_ab/`` and loaded with ``ctypes``; all expose the same C entry
points.  On the
serving lane's graph (``community_graph(26_000, n_communities=20, p_in=0.02,
p_out=0.0005, seed=0)``, symmetric ELL) with seeded heat it holds every
kernel of each build against the port's plain version (counts equal, flows
within atol 1e-5 / rtol 1e-4), then times each kernel by CUDA-graph replay,
the builds' graphs replayed in turns.  Shapes: ``maintain``'s 5 fields x
26,000 x 71 and pre-caching's 1 x 26,000 x 71 (batched pair), and warm
DHD's 27,136 x 80 (``StreamingHeat``'s width round8(71 + 8), 1,136 pad
rows; single-field pair).  Prints ptxas' registers and spills of each
build's DHD kernels and, as its last line, one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (timers, ptxas parser, tolerances)

ENTRIES = ("dhd_count_batch", "dhd_flow_batch", "dhd_count_single", "dhd_flow_single")


def build(checkouts: dict, sources=("dhd_spmv.cu",), entries=ENTRIES,
          out="dhd_ab") -> dict:
    """``{label: (library, ptxas report)}`` of each checkout's ``sources``
    (under ``src/repro_torch/csrc/``), built into ``build/<out>/`` with the
    C entry points ``entries`` bound."""
    from repro_torch.kernels import cuda_lib

    out_dir = ROOT / "build" / out
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, checkout in checkouts.items():
        csrc = checkout / "src" / "repro_torch" / "csrc"
        procs[label] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
             *(str(csrc / s) for s in sources), "-o", str(out_dir / f"{label}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    builds = {}
    for label, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            smoke.fail(f"nvcc failed on {checkouts[label]}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{label}.so"))
        for name in entries:
            fn = getattr(lib, name)
            fn.argtypes = list(cuda_lib._SIGNATURES[name])
            fn.restype = ctypes.c_int
        builds[label] = (lib, smoke.ptxas_report(log))
    return builds


def in_turns(fns: dict) -> dict:
    """Replayed ms of each of ``fns`` ({label: launch}), in turns: the
    labels, then the labels reversed, each the mean over its two places."""
    import numpy as np

    labels = list(fns)
    order = labels + labels[::-1]
    times = smoke.cuda_ms_in_turns([fns[x] for x in order], reps=9)
    return {x: float(np.mean([t for t, y in zip(times, order) if y == x])) for x in labels}


def lane_ell(width: int, rows: int):
    """The lane graph's symmetric ELL, ``width`` slots a row, padded with
    self-loops of weight 0 to ``rows`` rows."""
    import numpy as np

    from repro_torch.core.graph import build_csr, build_ell
    from repro_torch.data.synthetic import community_graph

    g = community_graph(26_000, n_communities=20, p_in=0.02, p_out=0.0005, seed=0, n_dcs=5)
    ell = build_ell(build_csr(g.n_nodes, g.src, g.dst, symmetrize=True), max_degree=width)
    if len(ell.tail_src):
        smoke.fail(f"the lane graph overflows {width} slots a row")
    n = ell.cols.shape[0]
    cols = np.concatenate([ell.cols, np.repeat(np.arange(n, rows, dtype=np.int32)[:, None],
                                               width, axis=1)])
    vals = np.concatenate([ell.vals, np.zeros((rows - n, width), np.float32)])
    return cols, vals


def launchers(lib, heat, cols, vals, q, nout, out):
    """``(count, flow)`` of one build: closures over its C entry points that
    read the current stream at launch."""
    from repro_torch.kernels.cuda_lib import stream_ptr

    p = (0.5, 0.9, 0.3)  # alpha, 1 - gamma, beta
    kmax = cols.shape[1]
    if heat.dim() == 1:
        n = heat.shape[0]
        return (
            lambda: lib.dhd_count_single(heat.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                                         nout.data_ptr(), n, kmax, stream_ptr(heat.device)),
            lambda: lib.dhd_flow_single(heat.data_ptr(), nout.data_ptr(), cols.data_ptr(),
                                        vals.data_ptr(), q.data_ptr(), out.data_ptr(), n,
                                        kmax, *p, stream_ptr(heat.device)),
        )
    B, n = heat.shape
    return (
        lambda: lib.dhd_count_batch(heat.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                                    nout.data_ptr(), B, n, kmax, 0, stream_ptr(heat.device)),
        lambda: lib.dhd_flow_batch(heat.data_ptr(), nout.data_ptr(), cols.data_ptr(),
                                   vals.data_ptr(), q.data_ptr(), out.data_ptr(), B, n, kmax,
                                   0, *p, stream_ptr(heat.device)),
    )


def main() -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.ref import dhd_ell_count_ref, dhd_ell_flow_ref

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=pathlib.Path, action="append", default=[],
                    help="another checkout to time against (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is False: dhd_ab needs a CUDA card")
    card = smoke.gpu_line()
    print(card, flush=True)
    builds = build({**{d.resolve().name: d.resolve() for d in args.base}, "this": ROOT})
    for label, (_, ptxas) in builds.items():
        for name, info in ptxas.items():
            if name.startswith(("dhd_count_kernel", "dhd_flow_single_kernel")):
                print(f"  ptxas {label}: {name}: {info}", flush=True)

    rng = np.random.default_rng(0)
    cases = []
    for case, B, width, rows in (("maintain", 5, 71, 26_000), ("pre-caching", 1, 71, 26_000),
                                 ("warm sweep", 0, 80, 27_136)):
        c_np, v_np = lane_ell(width, rows)
        cols = torch.as_tensor(c_np, device=smoke.DEVICE)
        vals = torch.as_tensor(v_np, device=smoke.DEVICE)
        shape = (B, rows) if B else (rows,)
        heat = torch.as_tensor(rng.random(shape, np.float32), device=smoke.DEVICE)
        q = torch.as_tensor(rng.random(shape, np.float32) * 0.1, device=smoke.DEVICE)
        h2, q2 = heat.reshape(-1, rows), q.reshape(-1, rows)
        want_n = dhd_ell_count_ref(h2, cols, vals)
        want = dhd_ell_flow_ref(h2, want_n, cols, vals, q2).reshape(shape)
        want_n = want_n.reshape(shape)
        fns = {}
        for label, (lib, _) in builds.items():
            nout, out = torch.empty_like(heat), torch.empty_like(heat)
            count, flow = launchers(lib, heat, cols, vals, q, nout, out)
            count()
            flow()
            torch.cuda.synchronize()
            if not torch.equal(nout, want_n):
                smoke.fail(f"{label} count kernel, {case}: differs from the plain version")
            if not torch.allclose(out, want, **smoke.DHD_TOL):
                smoke.fail(f"{label} flow kernel, {case}: outside atol 1e-5 / rtol 1e-4")
            fns[label] = (count, flow)
        live = (vals > 0).expand(h2.shape[0], rows, width)
        inflow = live & (h2[:, cols.long()] > h2[:, :, None])
        field = h2.numel() * 4
        ell = cols.numel() * 8
        row = {"case": case, "shape": [h2.shape[0], rows, width],
               "count_gathers": int(live.sum()), "flow_gathers": int(live.sum() + inflow.sum()),
               "count_bound_ms": (ell + 2 * field) / smoke.HBM_BYTES_PER_S * 1e3,
               "flow_bound_ms": (ell + 4 * field) / smoke.HBM_BYTES_PER_S * 1e3}
        for part in (0, 1):  # base, this, this, base: each build's graph in turns
            for x, t in in_turns({x: f[part] for x, f in fns.items()}).items():
                row[f"{('count', 'flow')[part]}_ms_{x}"] = t
        cases.append(row)
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    print(json.dumps({"dhd_ab": cases, "card": card}), flush=True)


if __name__ == "__main__":
    main()
