"""Exporters: Chrome trace-event JSON (Perfetto / chrome://tracing) and a
plain-text dashboard.

The Chrome exporter is deterministic by construction: tracks are mapped
to pids in sorted-name order, spans are emitted sorted by ``(t0, sid)``,
and the JSON is dumped with sorted keys — so two runs that produced
identical span streams serialize to byte-identical files.  Overlapping
root spans within a track are spread across lanes (tids) greedily;
children always render in their root's lane so nesting stays visually
intact.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .metrics import MetricsRegistry
from .trace import SpanRecord, Tracer

__all__ = ["export_chrome_trace", "text_dashboard"]

_US = 1e6  # trace-event timestamps are microseconds


def _lane_assignment(spans: List[SpanRecord]) -> Dict[int, int]:
    """Map sid → lane so overlapping roots get distinct lanes and every
    child inherits its root's lane."""
    by_sid = {s.sid: s for s in spans}

    def root_of(s: SpanRecord) -> SpanRecord:
        while s.parent is not None and s.parent in by_sid:
            s = by_sid[s.parent]
        return s

    roots = sorted(
        {root_of(s).sid for s in spans},
        key=lambda sid: (by_sid[sid].t0, sid),
    )
    lane_free: List[float] = []  # per-lane time the lane frees up
    root_lane: Dict[int, int] = {}
    for sid in roots:
        s = by_sid[sid]
        for i, free in enumerate(lane_free):
            if s.t0 >= free:
                root_lane[sid] = i
                lane_free[i] = s.t1
                break
        else:
            root_lane[sid] = len(lane_free)
            lane_free.append(s.t1)
    return {s.sid: root_lane[root_of(s).sid] for s in spans}


def export_chrome_trace(tracer: Tracer, path: Optional[str] = None) -> str:
    """Serialize the tracer's spans as Chrome trace-event JSON.

    Returns the JSON string; also writes it to ``path`` when given.  Load
    the file in https://ui.perfetto.dev or chrome://tracing.
    """
    spans = sorted(tracer.records, key=lambda s: (s.t0, s.sid))
    tracks = sorted({s.track for s in spans})
    pid_of = {track: i + 1 for i, track in enumerate(tracks)}

    events: List[dict] = []
    for track in tracks:
        events.append(
            {
                "ph": "M",
                "pid": pid_of[track],
                "tid": 0,
                "name": "process_name",
                "args": {"name": track},
            }
        )
    for track in tracks:
        track_spans = [s for s in spans if s.track == track]
        lanes = _lane_assignment(track_spans)
        for s in track_spans:
            events.append(
                {
                    "ph": "X",
                    "pid": pid_of[track],
                    "tid": lanes[s.sid],
                    "name": s.name,
                    "ts": round(s.t0 * _US, 3),
                    "dur": round(max(s.t1 - s.t0, 0.0) * _US, 3),
                    "args": {k: str(v) for k, v in sorted(s.tags.items())},
                }
            )
    text = json.dumps({"traceEvents": events}, sort_keys=True, separators=(",", ":"))
    if path is not None:
        with open(path, "w") as f:
            f.write(text + "\n")
    return text


def text_dashboard(registry: MetricsRegistry, tracer: Optional[Tracer] = None) -> str:
    """Human-readable one-screen summary of a registry (and optionally the
    span counts of a tracer)."""
    lines: List[str] = ["== metrics =="]
    snap = registry.snapshot()
    if not snap:
        lines.append("(no instruments recorded)")
    for name in sorted(snap):
        for tag_repr in sorted(snap[name]):
            row = snap[name][tag_repr]
            label = name if tag_repr == "-" else f"{name}{{{tag_repr}}}"
            if row["type"] == "histogram":
                q = row["quantiles"]
                qtxt = " ".join(f"{k}={v:.6g}" for k, v in sorted(q.items()))
                lines.append(
                    f"{label:58s} n={row['count']:<8d} mean={row['mean']:.6g} {qtxt}"
                )
            else:
                lines.append(f"{label:58s} {row['type']}={row['value']:.6g}")
    if tracer is not None:
        lines.append("== spans ==")
        counts: Dict[str, int] = {}
        for s in tracer.records:
            counts[f"{s.track}/{s.name}"] = counts.get(f"{s.track}/{s.name}", 0) + 1
        if not counts:
            lines.append("(no spans recorded)")
        for key in sorted(counts):
            lines.append(f"{key:58s} n={counts[key]}")
    return "\n".join(lines)
