"""Dry-run and roofline tables from the dry-run records, as markdown.

Port of ``repro/launch/make_experiments.py``: the same tables (the dry run on
each mesh, the multi-pod network pressure of the train cells, the roofline
of the single-pod mesh), written to ``EXPERIMENTS.md`` in the port's
results directory (``launch/results/``, or ``--results-dir``).  It never
writes the repository root.

Usage:
  python -m repro_torch.launch.make_experiments [--results-dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

from .roofline import NET_BW, NVLINK_BW, RESULTS_DIR, load_all, to_markdown

__all__ = ["crosspod_table", "dryrun_table", "main", "render"]


def _records(results_dir: str, mesh: str):
    for path in sorted(glob.glob(os.path.join(results_dir, f"dryrun_{mesh}_*.json"))):
        with open(path) as f:
            yield path, json.load(f)


def dryrun_table(mesh: str, results_dir: Optional[str] = None) -> str:
    rows = [
        "| cell | status | run (s) | flops/dev | args GiB | temp GiB | collectives |",
        "|---|---|---|---|---|---|---|",
    ]
    for _, r in _records(results_dir or RESULTS_DIR, mesh):
        cell = f"{r['arch']}/{r['shape']}"
        if r.get("skipped"):
            rows.append(f"| {cell} | SKIP ({r['skipped'][:48]}…) | | | | | |")
            continue
        if not r.get("ok"):
            rows.append(f"| {cell} | **FAIL** {r.get('error', '')[:60]} | | | | | |")
            continue
        p = r["production"]
        c = r.get("corrected", {})
        mem = p.get("memory", {})
        colls = c.get("collectives", p.get("collectives", {}))
        cstr = " ".join(f"{k}:{int(v['count'])}" for k, v in sorted(colls.items()))
        rows.append(
            f"| {cell} | ok | {p['t_run_s']:.0f} | "
            f"{c.get('flops_per_device', 0):.2e} | "
            f"{mem.get('argument_bytes', 0) / 2**30:.2f} | "
            f"{(mem.get('temp_bytes') or 0) / 2**30:.1f} | {cstr} |"
        )
    return "\n".join(rows)


def _wire(rec) -> float:
    c = rec.get("production", {}).get("collectives", {})
    return sum(v["wire_bytes"] for v in c.values())


def crosspod_table(results_dir: Optional[str] = None) -> str:
    """Pod-axis pressure: wire bytes multi against single, the difference
    priced at the network between nodes (``NET_BW``) against NVLink
    (``NVLINK_BW``).  The difference approximates the pod-crossing traffic
    a step adds when the batch spans two pods; int8 gradient compression
    (``distributed/compression.py``) divides the gradient share by ~4x."""
    rd = results_dir or RESULTS_DIR
    rows = [
        "| cell | wire single | wire multi | Δ (≈ between nodes) | Δ/NET_BW | note |",
        "|---|---|---|---|---|---|",
    ]
    for ps, rs in _records(rd, "single"):
        pm = ps.replace("dryrun_single_", "dryrun_multi_")
        if not os.path.exists(pm):
            continue
        with open(pm) as f:
            rm = json.load(f)
        if not (rs.get("ok") and rm.get("ok")) or rs.get("kind") != "train":
            continue  # the pod axis carries the gradient reduction of training
        ws, wm = _wire(rs), _wire(rm)
        delta = max(wm - ws, 0.0)
        note = "network-bound step" if delta / NET_BW > ws / NVLINK_BW else "NVLink still dominates"
        rows.append(
            f"| {rs['arch']}/{rs['shape']} | {ws:.2e} | {wm:.2e} | "
            f"{delta:.2e} | {delta / NET_BW:.3f} s | {note} |"
        )
    return "\n".join(rows)


def render(results_dir: Optional[str] = None) -> str:
    rd = results_dir or RESULTS_DIR
    out = ["### Dry run — single pod (16, 16), 256 ranks\n", dryrun_table("single", rd)]
    if glob.glob(os.path.join(rd, "dryrun_multi_*.json")):
        out += ["\n### Dry run — multi pod (2, 16, 16), 512 ranks\n", dryrun_table("multi", rd),
                "\n### Multi-pod network pressure (train cells)\n", crosspod_table(rd)]
    out += ["\n### Roofline — single pod, per device\n", to_markdown(load_all("single", rd))]
    return "\n".join(out) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", default=None)
    args = ap.parse_args()
    rd = args.results_dir or RESULTS_DIR
    path = os.path.join(rd, "EXPERIMENTS.md")
    with open(path, "w") as f:
        f.write(render(rd))
    print(f"wrote generated tables to {path}")


if __name__ == "__main__":
    main()
