"""Roofline analysis from the dry-run records.

Port of ``repro/launch/roofline.py``.  Per (arch x shape x mesh) cell it
derives the three roofline terms of one device's share of the step:

  compute    = flops / PEAK_FLOPS
  memory     = bytes / HBM_BW        (the dry run's unfused byte count)
  collective = wire_bytes / NVLINK_BW

plus MODEL_FLOPS (6*N*D dense / 6*N_active*D MoE; analytic edge/einsum
models for GNN/recsys), the useful-compute ratio, the dominant term, and a
one-line lever.  Reads ``launch/results/dryrun_*.json`` (written by
``python -m repro_torch.launch.dryrun``); writes a markdown table and a JSON
summary.

The constants are an NVIDIA H100 SXM's.  ``PEAK_FLOPS`` (a cuBLAS bf16
GEMM of 8192^3: 1.4087 ms) and ``HBM_BW`` (a device-to-device copy of 4 GiB,
read once and written once: 3.5120 ms) were measured by ``chip_smoke.py``
phase 19 (d) on an NVIDIA H100 80GB HBM3 at a 700 W power limit; the data
sheet's peaks are 989 TFLOP/s and 3.35 TB/s.  One card cannot measure the
links, so those are NVIDIA's published figures: ``NVLINK_BW`` is NVLink
4's 900 GB/s a GPU counted both ways (450 GB/s each way; H100 SXM data
sheet), the links within a node that the ``data`` and ``model`` axes map
to; ``NET_BW`` is one ConnectX-7 400 Gb/s port a GPU (50 GB/s; DGX H100
data sheet), the network between nodes that the ``pod`` axis maps to.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

__all__ = [
    "HBM_BW", "NET_BW", "NVLINK_BW", "PEAK_FLOPS", "RESULTS_DIR", "analyze", "load_all",
    "model_flops", "to_markdown", "wire_bytes",
]

# --- hardware constants (NVIDIA H100 SXM; sources in the module docstring) ---
PEAK_FLOPS = 7.804881e14  # bf16 GEMM, FLOP/s (measured)
HBM_BW = 2.445872e12  # bytes/s (measured)
NVLINK_BW = 450e9  # bytes/s a GPU, one direction
NET_BW = 50e9  # bytes/s a GPU between nodes (pod-axis collectives)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "results")


def wire_bytes(kind: str, tensor_bytes: float, group: float) -> float:
    """Ring wire bytes a device sends for one collective of ``kind`` whose
    result has ``tensor_bytes`` over a group of ``group`` ranks: the
    formulas of the reference's ``_parse_collectives``."""
    g = float(group)
    if kind == "all-gather":
        return tensor_bytes * (g - 1.0) / g
    if kind == "all-reduce":
        return 2.0 * tensor_bytes * (g - 1.0) / g
    if kind == "reduce-scatter":
        return tensor_bytes * (g - 1.0)  # result bytes are post-scatter
    if kind == "all-to-all":
        return tensor_bytes * (g - 1.0) / g
    return tensor_bytes  # collective-permute


# ---------------------------------------------------- analytic MODEL_FLOPS
def _lm_model_flops(arch_name: str, shape: str) -> Optional[float]:
    from ..configs import get_arch

    arch = get_arch(arch_name)
    cfg = arch.cfg
    n_active = cfg.active_param_count()
    s = arch.shape(shape)
    tokens = s.global_batch * s.seq_len
    if shape == "train_4k":
        return 6.0 * n_active * tokens  # fwd 2ND + bwd 4ND
    if shape == "prefill_32k":
        return 2.0 * n_active * tokens
    # decode: one token per sequence; attention reads S_ctx keys
    d_attn = (
        2.0 * cfg.n_layers * s.global_batch * s.seq_len
        * cfg.n_heads * cfg.hd * 2 * 2  # qk + pv, 2 flops/MAC
    )
    return 2.0 * n_active * s.global_batch + d_attn


def _gnn_model_flops(arch_name: str, shape: str) -> Optional[float]:
    from ..configs.base import GNN_SHAPES

    s = next(g for g in GNN_SHAPES if g.name == shape)
    N, E = s.n_nodes, s.n_edges
    # per-arch per-edge/node MAC models (x2 flops, x3 for fwd+bwd)
    if arch_name == "egnn":
        d = 64
        per_edge = (2 * d + 1) * d + d * d + d * d + d  # phi_e + phi_x
        per_node = 2 * d * d + d * d  # phi_h
        fwd = 4 * (E * per_edge + N * per_node) * 2
    elif arch_name == "meshgraphnet":
        d = 128
        per_edge = (3 * d) * d + d * d
        per_node = (2 * d) * d + d * d
        fwd = 15 * (E * per_edge + N * per_node) * 2
    elif arch_name == "schnet":
        d, r = 64, 300
        per_edge = r * d + d * d + d  # filter mlp + pre
        per_node = 2 * d * d
        fwd = 3 * (E * per_edge + N * per_node) * 2
    elif arch_name == "equiformer-v2":
        c, lmax, mmax = 128, 6, 2
        # SO(2) mixes: per |m| joint (l, c) matmul both directions
        so2 = sum(
            (2 if m else 1) * ((lmax + 1 - m) * c) ** 2 * 2
            for m in range(mmax + 1)
        )
        rot = 2 * sum((2 * l + 1) ** 2 for l in range(lmax + 1)) * c * 2
        per_edge = so2 + rot
        per_node = (lmax + 1) * c * c * 2 * 2  # out proj + ffn mix
        fwd = 12 * (E * per_edge + N * per_node)
    else:
        return None
    return 3.0 * fwd  # fwd + bwd


def _recsys_model_flops(shape: str) -> Optional[float]:
    from ..configs.base import RECSYS_SHAPES

    s = next(r for r in RECSYS_SHAPES if r.name == shape)
    d, L = 64, 21  # d_tok, seq+target
    attn = L * L * d * 2 * 3 + L * d * d * 4 * 2
    mlp = (L * d) * 1024 + 1024 * 512 + 512 * 256
    per_ex = (attn + mlp * 2)
    if s.kind == "train":
        return 3.0 * s.batch * per_ex
    if s.kind == "retrieval":
        return s.batch * (per_ex + 2.0 * s.n_candidates * 32)
    return 1.0 * s.batch * per_ex


def model_flops(arch: str, shape: str, family: str) -> Optional[float]:
    if family == "lm":
        return _lm_model_flops(arch, shape)
    if family == "gnn":
        return _gnn_model_flops(arch, shape)
    return _recsys_model_flops(shape)


# ----------------------------------------------------------------- analysis
def analyze(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if rec.get("skipped") or not rec.get("ok"):
        return None
    from ..configs import get_arch

    arch = get_arch(rec["arch"])
    n_chips = 1
    for v in rec["mesh_shape"].values():
        n_chips *= v
    corr = rec.get("corrected", {})
    flops_dev = max(corr.get("flops_per_device", 0.0), 0.0)
    bytes_dev = max(corr.get("bytes_accessed_per_device", 0.0), 0.0)
    colls = corr.get("collectives", {})
    wire = max(sum(v["wire_bytes"] for v in colls.values()), 0.0)
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_collective = wire / NVLINK_BW
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_collective,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"], arch.family)
    mf_dev = (mf / n_chips) if mf else None
    useful = (mf_dev / flops_dev) if (mf_dev and flops_dev) else None
    bound = max(terms.values())
    frac = t_compute / bound if bound > 0 else 0.0
    lever = {
        "compute_s": "compute-bound: fuse/kernel-level wins only (good place)",
        "memory_s": "memory-bound: raise arithmetic intensity (fuse, bf16 "
        "activations, bigger per-device batch, flash-style attention)",
        "collective_s": "collective-bound: reshard to cut cross-device traffic "
        "(GeoLayer halo/replica placement, overlap collectives with compute)",
    }[dominant]
    mem = rec.get("production", {}).get("memory", {})
    state = rec.get("production", {}).get("state_bytes_per_device", 0)
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "wire_bytes_per_device": wire,
        **terms,
        "dominant": dominant.replace("_s", ""),
        "roofline_fraction": frac,
        "model_flops_per_device": mf_dev,
        "useful_flops_ratio": useful,
        "state_gib_per_device": state / 2**30,
        "temp_gib_per_device": (mem.get("temp_bytes") or 0) / 2**30,
        "args_gib_per_device": mem.get("argument_bytes", 0) / 2**30,
        "lever": lever,
        "collective_detail": colls,
    }


def load_all(mesh: str = "single", results_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    out = []
    pattern = os.path.join(results_dir or RESULTS_DIR, f"dryrun_{mesh}_*.json")
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            rec = json.load(f)
        a = analyze(rec)
        if a:
            out.append(a)
        elif rec.get("skipped"):
            out.append(
                {"arch": rec["arch"], "shape": rec["shape"], "mesh": mesh,
                 "skipped": rec["skipped"]}
            )
    return out


def to_markdown(rows: List[Dict[str, Any]]) -> str:
    hdr = (
        "| cell | compute (s) | memory (s) | collective (s) | dominant | "
        "roofline frac | useful ratio | state GiB | temp GiB |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        cell = f"{r['arch']}/{r['shape']}"
        if r.get("skipped"):
            lines.append(f"| {cell} | — | — | — | SKIP | — | — | — | — |")
            continue
        u = r.get("useful_flops_ratio")
        us = f"{u:.2f}" if u else "n/a"
        lines.append(
            f"| {cell} | {r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"{r['collective_s']:.3e} | **{r['dominant']}** | "
            f"{r['roofline_fraction']:.2f} | {us} | "
            f"{r['state_gib_per_device']:.2f} | {r['temp_gib_per_device']:.2f} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--results-dir", default=None)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    rows = load_all(args.mesh, args.results_dir)
    print(to_markdown(rows))
    out = args.json_out or os.path.join(args.results_dir or RESULTS_DIR, "roofline.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    live = [r for r in rows if not r.get("skipped")]
    if live:
        worst = min(live, key=lambda r: r["roofline_fraction"])
        collb = max(live, key=lambda r: r["collective_s"])
        print(f"worst roofline fraction: {worst['arch']}/{worst['shape']} "
              f"({worst['roofline_fraction']:.2f})")
        print(f"most collective-bound:  {collb['arch']}/{collb['shape']} "
              f"({collb['collective_s']:.3e}s)")


if __name__ == "__main__":
    main()
