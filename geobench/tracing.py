"""Traced runs: the profiled sub-window and the readers.

A traced run profiles ``PROFILE_S`` seconds of its window with
``torch.profiler`` (CPU and CUDA activities).  Device time comes only from
the profiler's device events; idle gaps are labelled by what the harness
was doing then.

Each per-layer metric is read by ``metrics/<name>.py``, whose ``read(ctx)``
returns a number or ``None`` when the run gave it nothing to read.
"""
from __future__ import annotations

import importlib.util
import time
from typing import Dict, List, Optional

__all__ = ["warm_profiler", "start_profile", "device_summary", "per_layer_values"]

class Profile:
    def __init__(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        with torch.profiler.record_function("geobench.mark"):
            self.t_mark = time.perf_counter()
        self.t_start = time.perf_counter()
        self.stopped = False

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stopped = True


def warm_profiler() -> None:
    """Open and close the profiler once in set-up: its first start loads
    CUPTI, which takes seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def start_profile() -> Profile:
    return Profile()


def _events(prof) -> list:
    return list(prof.prof.profiler.kineto_results.events())


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _label(t: float, ctx: dict) -> str:
    """What the harness was doing at ``perf_counter`` time ``t``."""
    for a, b, _ in ctx["probe"]:
        if a <= t <= b:
            return "store.serve_batch"
    order = {"step": 0, "submit": 1, "apply": 2, "catalog": 3}
    best = None
    for label, a, b in ctx["timeline"].spans:
        if a <= t <= b and (best is None or order[label] < order[best]):
            best = label
    return {None: "harness.wait", "step": "controller.step outside serve_batch",
            "submit": "harness.submit", "apply": "harness.apply",
            "catalog": "harness.catalog"}[best]


def device_summary(ctx: dict) -> Optional[dict]:
    import torch

    prof = ctx["prof"]
    evs = _events(prof)
    mark = next((e for e in evs if e.name() == "geobench.mark"), None)
    if mark is None:
        return None
    offset = prof.t_mark - mark.start_ns() * 1e-9  # profiler ns -> perf_counter s
    lo, hi = prof.t_start, prof.t_stop
    dev = []
    for e in evs:
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        a = e.start_ns() * 1e-9 + offset
        b = a + e.duration_ns() * 1e-9
        a, b = max(a, lo), min(b, hi)
        if b > a:
            dev.append((e.name(), a, b))
    busy = _union([(a, b) for _, a, b in dev])
    busy_s = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    idle_by: Dict[str, float] = {}
    for a, b in gaps:
        lab = _label(0.5 * (a + b), ctx)
        idle_by[lab] = idle_by.get(lab, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": hi - lo,
        "breakdown": {
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(idle_by.items(), key=lambda kv: -kv[1])][:10],
        },
    }


def _reader(name: str):
    path = __import__("pathlib").Path(__file__).resolve().parent / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"geobench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_values(cell, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader found."""
    out = {}
    for m in cell.per_layer:
        v = _reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
