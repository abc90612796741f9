"""Metrics registry (stdlib + numpy only): counters, gauges, and streaming
quantile histograms.

Everything here is bounded-memory by construction.  Histograms use the
P-squared (P²) streaming-quantile sketch of Jain & Chlamtac (1985): five
markers per tracked quantile, adjusted with a parabolic (fallback linear)
update on every observation.  No sample list is ever kept, so a histogram
costs O(1) memory no matter how many values it absorbs.

The process-default registry starts *disabled*: every instrument handed
out by a disabled registry is a shared no-op singleton, so instrumented
hot paths cost one attribute load and a branch.  Components that want
telemetry either flip the default registry on (``get_registry().enable()``)
or install their own via :func:`set_default_registry`.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MatrixCounter",
    "MetricsRegistry",
    "P2Quantile",
    "get_registry",
    "set_default_registry",
]

TagKey = Tuple[Tuple[str, str], ...]


def _tag_key(tags: Mapping[str, object]) -> TagKey:
    return tuple(sorted((k, str(v)) for k, v in tags.items()))


class P2Quantile:
    """P² streaming estimator for a single quantile ``q`` (0 < q < 1).

    Keeps 5 marker heights/positions; after 5 observations each ``add``
    is O(1).  Estimates are exact until the 5th sample, then converge to
    the true quantile as the stream grows.
    """

    __slots__ = ("q", "n", "_heights", "_pos", "_want", "_dwant")

    # max settle passes per add_many batch (see the comment there)
    SETTLE_PASSES = 2

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self.n = 0
        self._heights: list = []
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._want = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self._dwant = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def add(self, x: float) -> None:
        self.n += 1
        h = self._heights
        if len(h) < 5:
            h.append(x)
            h.sort()
            return
        # locate the cell containing x, clamping the extreme markers
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        pos = self._pos
        for i in range(k + 1, 5):
            pos[i] += 1.0
        want = self._want
        for i in range(5):
            want[i] += self._dwant[i]
        # nudge interior markers toward their desired positions
        self._nudge(1)
        self._nudge(2)
        self._nudge(3)

    def add_many(self, sorted_values) -> None:
        """Absorb a pre-sorted batch in one pass (batch-P²).

        Marker positions advance by per-batch rank counts (one searchsorted
        across the markers) instead of once per observation, then the
        interior heights are nudged toward their desired positions with the
        usual parabolic/linear steps, iterated until the markers settle.
        Statistically this matches scalar P² — both are O(1)-memory
        approximations whose error vanishes as the stream grows — at a
        per-batch cost that no longer scales with the batch size.
        """
        m = len(sorted_values)
        if m == 0:
            return
        h = self._heights
        if len(h) < 5:
            if self.n == 0 and m >= 5:
                # markers placed straight at their desired ranks — feeding
                # the 5 *smallest* values instead (the batch is sorted!)
                # would pin the low markers at the distribution floor with
                # unit position gaps, deadlocking every later adjustment
                self._init_from_sorted(sorted_values)
            else:
                for v in sorted_values:
                    self.add(float(v))
            return
        vals = sorted_values
        self.n += m
        lo, hi = float(vals[0]), float(vals[-1])
        if lo < h[0]:
            h[0] = lo
        if hi >= h[4]:
            h[4] = hi
        # interior markers advance by their batch rank (#values strictly
        # below, matching the scalar cell search); the max marker absorbs
        # every observation
        below = np.searchsorted(vals, h[1:4], side="left")
        pos = self._pos
        pos[1] += float(below[0])
        pos[2] += float(below[1])
        pos[3] += float(below[2])
        pos[4] += float(m)
        want = self._want
        dwant = self._dwant
        for i in range(1, 5):
            want[i] += m * dwant[i]
        # settle: each pass moves an out-of-place marker one position.  The
        # pass count is capped — heavily tied streams (discrete latency
        # values) otherwise make markers chase their desired rank for ~m
        # passes per batch.  Residual want-pos deviation is zero-mean and
        # carries over, so later batches absorb it; the height estimate
        # oscillates inside the tie neighbourhood, which is the correct
        # quantile there anyway.
        # pass budget scales with the batch so pooled (buffered) batches get
        # proportionally more settle opportunities — a flat cap starves the
        # markers when thousands of values arrive in one flush
        for _ in range(min(m, self.SETTLE_PASSES + m // 256)):
            moved = self._nudge(1)
            moved |= self._nudge(2)
            moved |= self._nudge(3)
            if not moved:
                break

    def _init_from_sorted(self, vals) -> None:
        """Seed all five markers from one sorted batch: heights at the
        desired rank positions, which is the fixed point scalar P² converges
        toward for a stream with this empirical distribution."""
        m = len(vals)
        q = self.q
        self.n = m
        pos = [
            1.0,
            1.0 + (m - 1) * q / 2.0,
            1.0 + (m - 1) * q,
            1.0 + (m - 1) * (1.0 + q) / 2.0,
            float(m),
        ]
        self._pos = list(pos)
        self._want = list(pos)
        self._heights = [float(vals[int(round(p)) - 1]) for p in pos]

    def _nudge(self, i: int) -> bool:
        h, pos, want = self._heights, self._pos, self._want
        d = want[i] - pos[i]
        if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
            d <= -1.0 and pos[i - 1] - pos[i] < -1.0
        ):
            d = 1.0 if d > 0 else -1.0
            hp = self._parabolic(i, d)
            if h[i - 1] < hp < h[i + 1]:
                h[i] = hp
            else:  # parabolic step would cross a neighbour: go linear
                j = i + int(d)
                h[i] = h[i] + d * (h[j] - h[i]) / (pos[j] - pos[i])
            pos[i] += d
            return True
        return False

    def _parabolic(self, i: int, d: float) -> float:
        h, pos = self._heights, self._pos
        return h[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d) * (h[i + 1] - h[i]) / (pos[i + 1] - pos[i])
            + (pos[i + 1] - pos[i] - d) * (h[i] - h[i - 1]) / (pos[i] - pos[i - 1])
        )

    def value(self) -> float:
        h = self._heights
        if not h:
            return math.nan
        if len(h) < 5 or self.n <= 5:
            # exact small-sample quantile (nearest-rank interpolation)
            idx = self.q * (len(h) - 1)
            lo = int(idx)
            hi = min(lo + 1, len(h) - 1)
            return h[lo] + (idx - lo) * (h[hi] - h[lo])
        return h[2]


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "tags", "value")

    def __init__(self, name: str, tags: TagKey = ()):
        self.name = name
        self.tags = tags
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "tags", "value")

    def __init__(self, name: str, tags: TagKey = ()):
        self.name = name
        self.tags = tags
        self.value = math.nan

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}

    def reset(self) -> None:
        self.value = math.nan


class Histogram:
    """Streaming histogram: count/sum/min/max plus P² quantile sketches."""

    __slots__ = (
        "name", "tags", "quantiles", "count", "sum", "min", "max",
        "_sketches", "_buf", "_buf_n",
    )

    DEFAULT_QUANTILES = (0.5, 0.9, 0.99)

    # batches accumulate here before the P² sketches see them: marker math
    # costs ~50-100us of cold-cache Python per batch, which the 5% serving
    # telemetry budget cannot pay at every serve_batch.  count/sum/min/max
    # stay exact per batch; sketches are fed the pooled sorted buffer once
    # it crosses this many values (or on any quantile read)
    FLUSH_AT = 8192

    def __init__(
        self,
        name: str,
        tags: TagKey = (),
        quantiles: Iterable[float] = DEFAULT_QUANTILES,
    ):
        self.name = name
        self.tags = tags
        self.quantiles = tuple(quantiles)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._sketches = [P2Quantile(q) for q in self.quantiles]
        self._buf: list = []
        self._buf_n = 0

    def observe(self, value: float) -> None:
        if self._buf_n:
            self._flush()
        value = float(value)
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        for s in self._sketches:
            s.add(value)

    def observe_many(self, values) -> None:
        """Vectorized :meth:`observe` for a whole batch.

        count/sum/min/max update immediately (exact at every read); the
        values are buffered and fed to the P² sketches — one shared sort,
        batch-P² per sketch — only when :attr:`FLUSH_AT` values have pooled
        or a quantile is read, amortizing the marker math across batches."""
        vals = np.asarray(values, dtype=float)
        m = int(vals.size)
        if m == 0:
            return
        if m == 1:
            self.observe(float(vals[0]))
            return
        self.count += m
        self.sum += float(vals.sum())
        lo = float(vals.min())
        hi = float(vals.max())
        if lo < self.min:
            self.min = lo
        if hi > self.max:
            self.max = hi
        self._buf.append(vals)
        self._buf_n += m
        if self._buf_n >= self.FLUSH_AT:
            self._flush()

    def _flush(self) -> None:
        buf = self._buf
        if not buf:
            return
        vals = buf[0] if len(buf) == 1 else np.concatenate(buf)
        vals = np.sort(vals, axis=None)
        self._buf = []
        self._buf_n = 0
        for s in self._sketches:
            s.add_many(vals)

    def quantile(self, q: float) -> float:
        if self._buf_n:
            self._flush()
        for s in self._sketches:
            if s.q == q:
                return s.value()
        raise KeyError(f"quantile {q} not tracked by {self.name}")

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def snapshot(self) -> dict:
        if self._buf_n:
            self._flush()
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else math.nan,
            "max": self.max if self.count else math.nan,
            "quantiles": {f"p{q * 100:g}": s.value() for q, s in zip(self.quantiles, self._sketches)},
        }

    def reset(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._sketches = [P2Quantile(q) for q in self.quantiles]
        self._buf = []
        self._buf_n = 0


class MatrixCounter:
    """2-D grid of counters addressed by integer tag pairs.

    Hot paths that account a whole ``[n, m]`` matrix per batch (per-link WAN
    bytes keyed ``(src DC, dst DC)``) pay one numpy add instead of one
    registry lookup per cell.  :meth:`MetricsRegistry.snapshot` expands the
    nonzero cells into ordinary per-cell counter entries, so consumers see
    the same shape as individually tagged counters.
    """

    __slots__ = ("name", "tags", "axes", "value")

    def __init__(self, name: str, tags: TagKey = (), axes: Tuple[str, str] = ("i", "j")):
        self.name = name
        self.tags = tags
        self.axes = axes
        self.value = np.zeros((0, 0))

    def add(self, mat) -> None:
        mat = np.asarray(mat, dtype=float)
        if mat.shape != self.value.shape:
            grown = np.zeros(
                (
                    max(mat.shape[0], self.value.shape[0]),
                    max(mat.shape[1], self.value.shape[1]),
                )
            )
            grown[: self.value.shape[0], : self.value.shape[1]] = self.value
            self.value = grown
        self.value[: mat.shape[0], : mat.shape[1]] += mat

    def cells(self):
        """Yield ``(tag_repr, counter_snapshot)`` for every nonzero cell."""
        ai, aj = self.axes
        for i, j in zip(*(a.tolist() for a in np.nonzero(self.value))):
            yield f"{ai}={i},{aj}={j}", {
                "type": "counter",
                "value": float(self.value[i, j]),
            }

    def snapshot(self) -> dict:
        return {"type": "counter_grid", "cells": dict(self.cells())}

    def reset(self) -> None:
        self.value = np.zeros((0, 0))


class _NoopInstrument:
    """Shared do-nothing stand-in handed out by a disabled registry."""

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def observe_many(self, values) -> None:
        pass

    def add(self, mat) -> None:
        pass

    value = math.nan
    count = 0
    sum = 0.0

    def quantile(self, q: float) -> float:
        return math.nan


_NOOP = _NoopInstrument()


class MetricsRegistry:
    """Keyed store of instruments.

    Instruments are keyed on ``(name, sorted tags)``; asking twice for the
    same key returns the same object.  A disabled registry hands out a
    shared no-op singleton instead, so call sites never branch themselves.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, TagKey], object] = {}
        # hot callers park pre-resolved instrument handles here (keyed by
        # caller-chosen name) so a serve-path batch pays one dict get
        # instead of one keyed lookup per instrument; cleared with the
        # instruments so handles can never outlive them
        self._handle_cache: Dict[str, object] = {}

    # -- lifecycle ---------------------------------------------------------
    def enable(self) -> "MetricsRegistry":
        self.enabled = True
        return self

    def disable(self) -> "MetricsRegistry":
        self.enabled = False
        return self

    def reset(self) -> None:
        with self._lock:
            for inst in self._instruments.values():
                inst.reset()

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()
            self._handle_cache.clear()

    # -- instrument accessors ---------------------------------------------
    def _get_keyed(self, cls, name: str, key: TagKey, **kw):
        if not self.enabled:
            return _NOOP
        k = (name, key)
        inst = self._instruments.get(k)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(k)
                if inst is None:
                    inst = cls(name, key, **kw)
                    self._instruments[k] = inst
        return inst

    def _get(self, cls, name: str, tags: Mapping[str, object], **kw):
        return self._get_keyed(cls, name, _tag_key(tags), **kw)

    def counter(self, name: str, **tags) -> Counter:
        return self._get(Counter, name, tags)

    def counter_keyed(self, name: str, key: TagKey) -> Counter:
        """Hot-path :meth:`counter`: takes the already-normalized tag key
        (the ``tuple(sorted((k, str(v))))`` form), skipping per-call tag
        sorting/stringification — for call sites that cache their keys."""
        return self._get_keyed(Counter, name, key)

    def counter_grid(self, name: str, axes: Tuple[str, str]) -> MatrixCounter:
        """Grid of counters over two integer-valued tag axes; one
        :meth:`MatrixCounter.add` accounts a whole matrix per batch."""
        return self._get_keyed(MatrixCounter, name, (), axes=axes)

    def gauge(self, name: str, **tags) -> Gauge:
        return self._get(Gauge, name, tags)

    def histogram(
        self,
        name: str,
        quantiles: Iterable[float] = Histogram.DEFAULT_QUANTILES,
        **tags,
    ) -> Histogram:
        return self._get(Histogram, name, tags, quantiles=quantiles)

    # -- aggregation -------------------------------------------------------
    @staticmethod
    def merge(snapshots: Iterable[Mapping[str, Mapping[str, dict]]]) -> dict:
        """Merge per-shard :meth:`snapshot` dicts into one aggregate view.

        The sharded store's per-shard registries export independently; this
        folds them into a single dashboard/trace-exportable snapshot:

          * counters sum (matrix-counter cells already export as per-cell
            counters, so per-link byte grids add element-wise);
          * gauges keep the last non-NaN write (snapshot order);
          * histograms merge exactly on count/sum/min/max (mean recomputed)
            and approximately on quantiles — a count-weighted average of the
            per-shard P² estimates, the standard sketch-merge compromise.

        Returns a plain dict in :meth:`snapshot` shape.
        """
        out: Dict[str, Dict[str, dict]] = {}
        for snap in snapshots:
            for name, by_tag in snap.items():
                dst_by = out.setdefault(name, {})
                for tag, inst in by_tag.items():
                    cur = dst_by.get(tag)
                    if cur is None:
                        dst_by[tag] = {
                            k: (dict(v) if isinstance(v, dict) else v)
                            for k, v in inst.items()
                        }
                        if inst.get("type") == "histogram":
                            # stash the weights quantile-averaging needs
                            dst_by[tag]["_qweight"] = {
                                q: inst["count"]
                                for q, v in inst.get("quantiles", {}).items()
                                if not math.isnan(v)
                            }
                        continue
                    if cur["type"] != inst["type"]:
                        raise ValueError(
                            f"{name}/{tag}: cannot merge {inst['type']} "
                            f"into {cur['type']}"
                        )
                    if cur["type"] == "counter":
                        cur["value"] += inst["value"]
                    elif cur["type"] == "gauge":
                        if not math.isnan(inst["value"]):
                            cur["value"] = inst["value"]
                    elif cur["type"] == "histogram":
                        _merge_histogram_snapshots(cur, inst)
                    else:
                        raise ValueError(
                            f"{name}/{tag}: unmergeable type {cur['type']!r}"
                        )
        for by_tag in out.values():
            for inst in by_tag.values():
                inst.pop("_qweight", None)
        return out

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Nested-dict view: ``{name: {tag_repr: instrument_snapshot}}``."""
        out: Dict[str, dict] = {}
        with self._lock:
            items = sorted(self._instruments.items())
        for (name, tags), inst in items:
            if isinstance(inst, MatrixCounter):
                out.setdefault(name, {}).update(inst.cells())
                continue
            tag_repr = ",".join(f"{k}={v}" for k, v in tags) or "-"
            out.setdefault(name, {})[tag_repr] = inst.snapshot()
        return out

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        text = json.dumps(self.snapshot(), indent=indent, sort_keys=True, default=str)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text


def _merge_histogram_snapshots(cur: dict, inst: dict) -> None:
    """Fold histogram snapshot ``inst`` into ``cur`` (in place).

    count/sum/min/max merge exactly; each tracked quantile becomes the
    count-weighted average of the shard estimates (``_qweight`` carries the
    accumulated weight per quantile so later folds stay correctly weighted).
    """
    n_new = inst["count"]
    cur["count"] += n_new
    cur["sum"] += inst["sum"]
    cur["mean"] = cur["sum"] / cur["count"] if cur["count"] else math.nan
    for key, pick in (("min", min), ("max", max)):
        v = inst[key]
        if not math.isnan(v):
            cur[key] = v if math.isnan(cur[key]) else pick(cur[key], v)
    weights = cur.setdefault("_qweight", {})
    quant = cur.setdefault("quantiles", {})
    for q, v in inst.get("quantiles", {}).items():
        if math.isnan(v) or n_new == 0:
            continue
        w_old = weights.get(q, 0)
        old = quant.get(q, math.nan)
        if w_old == 0 or math.isnan(old):
            quant[q] = v
        else:
            quant[q] = (old * w_old + v * n_new) / (w_old + n_new)
        weights[q] = w_old + n_new


_default_registry = MetricsRegistry(enabled=False)  # geolint: allow[GL001]


def get_registry() -> MetricsRegistry:
    """The process-default registry (starts disabled)."""
    return _default_registry


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Install ``registry`` as the process default; returns the previous one."""
    global _default_registry
    old = _default_registry
    _default_registry = registry
    return old
