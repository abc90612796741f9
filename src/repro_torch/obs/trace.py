"""Nested span tracing with an injectable clock.

A :class:`Tracer` produces :class:`SpanRecord` rows under any monotonic
clock — ``time.perf_counter`` for wall-clock store work, or the serving
scheduler's :class:`~repro_torch.serve.scheduler.SimClock` so control-plane
traces are fully deterministic (same seed → byte-identical export).

Two ways to produce spans:

* ``with tracer.span("route", track="store", layer=2): ...`` — live
  context-manager spans; parenting follows the opening thread's own
  nesting stack, or ``parent=sid`` for a span opened on a worker thread
  on behalf of a span of another thread.
* ``tracer.record("request", t0, t1, track="requests", parent=sid, ...)``
  — explicit-timestamp spans for events whose start/end were computed by
  a simulator rather than observed live.

Beside the spans, ``tracer.count("route.device_slots", n, variant=...)``
adds to a named counter under its tags (:attr:`Tracer.counters`).

Records are held in a bounded deque so a forgotten tracer can never grow
without limit.  Span ids come from one atomic counter and each thread
nests on a stack of its own, so threads of a pool may trace at once.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from .metrics import get_registry

__all__ = ["Span", "SpanRecord", "Tracer"]


@dataclass
class SpanRecord:
    """One finished span. Times are in the tracer's clock domain (seconds)."""

    sid: int
    name: str
    t0: float
    t1: float
    track: str = "main"
    parent: Optional[int] = None
    tags: Dict[str, object] = field(default_factory=dict)

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0


class Span:
    """A live span; ``end()`` is idempotent and happens automatically when
    used as a context manager."""

    __slots__ = ("_tracer", "_stack", "sid", "name", "t0", "t1", "track", "parent",
                 "tags")

    def __init__(self, tracer: "Tracer", sid: int, name: str, t0: float,
                 track: str, parent: Optional[int], tags: Dict[str, object],
                 stack: list):
        self._tracer = tracer
        self._stack = stack  # the opening thread's nesting stack
        self.sid = sid
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.track = track
        self.parent = parent
        self.tags = tags

    def elapsed_s(self) -> float:
        """Seconds since the span started (final duration once ended)."""
        if self.t1 is not None:
            return self.t1 - self.t0
        return self._tracer.clock() - self.t0

    def tag(self, **tags) -> None:
        """Add tags known only once the span is open."""
        self.tags.update(tags)

    def end(self) -> float:
        if self.t1 is None:
            self.t1 = self._tracer.clock()
            self._tracer._finish(self)
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NoopSpan:
    """Stand-in returned by a disabled tracer; still measures elapsed time
    so report fields (``apply_time_s`` etc.) stay correct when telemetry
    is off."""

    __slots__ = ("_clock", "t0", "t1")
    sid = None
    parent = None

    def __init__(self, clock: Callable[[], float]):
        self._clock = clock
        self.t0 = clock()
        self.t1: Optional[float] = None

    def elapsed_s(self) -> float:
        if self.t1 is not None:
            return self.t1 - self.t0
        return self._clock() - self.t0

    def tag(self, **tags) -> None:
        pass

    def end(self) -> float:
        if self.t1 is None:
            self.t1 = self._clock()
        return self.t1 - self.t0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class Tracer:
    """Span collector.

    Parameters
    ----------
    clock:
        Zero-arg callable returning seconds.  Defaults to
        ``time.perf_counter``; pass ``SimClock.now`` (bound method) for
        deterministic simulated-time traces.
    enabled:
        ``True``/``False`` force the state; ``None`` (default) follows the
        process-default metrics registry, so flipping telemetry on in one
        place lights up both metrics and traces.
    max_spans:
        Bound on retained finished spans (oldest evicted first).
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        enabled: Optional[bool] = None,
        max_spans: int = 1_000_000,
    ):
        self.clock = clock
        self._enabled = enabled
        self.records: deque = deque(maxlen=max_spans)
        # counters by (name, sorted tags), for work that a span's tags do
        # not sum over threads and calls
        self.counters: Dict[tuple, float] = {}
        self._count_lock = threading.Lock()
        self._ids = itertools.count()
        self._local = threading.local()  # .stack: this thread's open span sids

    @property
    def enabled(self) -> bool:
        if self._enabled is None:
            return get_registry().enabled
        return self._enabled

    def _thread_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- span production ---------------------------------------------------
    def span(self, name: str, track: str = "main", parent: Optional[int] = None,
             **tags):
        """Open a live span; use as a context manager or call ``end()``.

        Its parent is ``parent`` when given, else the innermost span open
        on the calling thread.  Spans opened under it on this thread nest
        under it either way."""
        if not self.enabled:
            return _NoopSpan(self.clock)
        sid = next(self._ids)
        stack = self._thread_stack()
        if parent is None and stack:
            parent = stack[-1]
        stack.append(sid)
        return Span(self, sid, name, self.clock(), track, parent, tags, stack)

    def record(
        self,
        name: str,
        t0: float,
        t1: float,
        track: str = "main",
        parent: Optional[int] = None,
        **tags,
    ) -> Optional[int]:
        """Record a span with explicit timestamps; returns its sid (or
        ``None`` when disabled) so callers can parent children onto it."""
        if not self.enabled:
            return None
        sid = next(self._ids)
        self.records.append(
            SpanRecord(sid, name, t0, t1, track=track, parent=parent, tags=tags)
        )
        return sid

    def count(self, name: str, n: float = 1, **tags) -> None:
        """Add ``n`` to the counter ``name`` under ``tags`` (a no-op when
        disabled); :attr:`counters` holds the totals."""
        if not self.enabled:
            return
        key = (name, tuple(sorted(tags.items())))
        with self._count_lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def _finish(self, span: Span) -> None:
        # context-manager spans may end out of LIFO order under odd control
        # flow; remove this sid wherever it sits in the stack
        try:
            span._stack.remove(span.sid)
        except ValueError:
            pass
        self.records.append(
            SpanRecord(
                span.sid, span.name, span.t0, span.t1,
                track=span.track, parent=span.parent, tags=span.tags,
            )
        )

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        self.records.clear()
        self.counters.clear()
        self._local = threading.local()
        self._ids = itertools.count()

    def __len__(self) -> int:
        return len(self.records)
