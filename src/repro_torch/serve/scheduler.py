"""Event-driven admission control with latency-aware adaptive batching.

The :class:`AdmissionController` replaces the old synchronous FIFO drain
loop with an event-loop scheduler on a **simulated clock** (deterministic,
no threads):

  * requests arrive (immediately or on a replayed trace via ``at=``), are
    queued per ``(priority class, origin DC)``, and drain in batches through
    the data plane's vectorized ``store.serve_batch``;
  * the **batch size closes the loop on measured routing latency**: every
    drain observes its requests' ``RouteResult.latency_s`` (the Eq. 1 WAN
    straggler) and the controller grows the batch target while the marginal
    p99 stays inside the deadline slack, shrinking multiplicatively on a
    deadline miss (AIMD) — latency-aware batch sizing;
  * **per-origin fairness**: batches are formed round-robin across origin
    queues (``quantum`` requests per origin per pass, priority classes
    first), so one hot DC cannot starve the others — with ``fairness="fifo"``
    the controller degrades to the old global-FIFO order.

Timing model (all simulated seconds): dispatching a batch of R requests
occupies the router for ``dispatch_overhead_s + R * per_request_s``; the
batch's results return together when its straggler WAN fetch lands, so every
request in it completes at ``dispatch + compute + max(latency_s)``.  The
router is free to form the next batch once the compute window ends (fetches
overlap the next drain).  Batching therefore couples a local request's
completion to the slowest remote fetch in its batch — exactly the tension
the adaptive policy trades against per-dispatch overhead.

Routing is untouched policy-free data-plane work: the controller hands the
formed batch to ``serve_batch`` verbatim, so results are request-for-request
identical to calling the store directly on the same batches (asserted in
``tests/test_control_plane.py`` and ``tests/test_torch_control_plane.py``).

Idle gaps (router quiescent, next arrival in the future) are offered to an
attached :class:`~repro_torch.serve.MaintenancePolicy` before the clock jumps
forward — migration waves, compaction and heat maintenance run "between
drains" without a second event loop.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..obs import Tracer
from .client import RequestHandle

__all__ = ["SimClock", "AdmissionConfig", "BatchRecord", "AdmissionController"]


class SimClock:
    """Deterministic simulated clock (seconds); monotone, never wall time."""

    def __init__(self, t0: float = 0.0) -> None:
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot go backwards (dt={dt})")
        self.t += dt

    def jump_to(self, t: float) -> None:
        self.t = max(self.t, float(t))


@dataclasses.dataclass
class AdmissionConfig:
    """Scheduler knobs.  ``policy`` selects the batching discipline:

    * ``"adaptive"`` (default) — AIMD batch target driven by measured
      latency vs deadline slack; dispatches whenever the router is free.
    * ``"greedy"`` — dispatch whenever free, fixed cap ``max_batch``
      (work-conserving fixed batching).
    * ``"fixed"`` — wait until ``max_batch`` requests are pending before
      dispatching (trailing partial drain once arrivals end): the
      fixed-batch FIFO frontend the benchmarks baseline against.
    """

    policy: str = "adaptive"
    fairness: str = "round_robin"  # or "fifo"
    # one AIMD batch target per store shard (sharded stores expose
    # ``origin_shard``): each drain serves a single shard, round-robin
    # across shards with pending work, so a lagging shard shrinks its own
    # target without throttling the healthy ones
    per_shard_aimd: bool = False
    min_batch: int = 1
    max_batch: int = 256
    initial_batch: int = 8
    quantum: int = 8  # per-origin requests taken per round-robin pass
    # router occupancy charged per drain.  "occupancy" (default) keeps the
    # deterministic linear model below; "measured" charges the store's
    # actual serving time instead — ``store.last_serve_seconds`` (the
    # sharded store reports its slowest shard's busy seconds) with the
    # drain's own wall clock as fallback — so the AIMD loop reacts to the
    # real router (e.g. the kernels fast path making big batches cheap).
    # Measured mode injects wall time into the simulated clock: runs are
    # no longer replay-deterministic, which is the point.
    service_model: str = "occupancy"
    # simulated router occupancy per drain ("occupancy" model constants)
    dispatch_overhead_s: float = 2e-3
    per_request_s: float = 2e-5
    # AIMD loop
    growth: float = 1.5
    shrink: float = 0.5
    slack_frac: float = 0.25  # grow only while slack > frac of the deadline
    latency_window: int = 256  # sliding window backing the p99 estimate
    # telemetry bounds: the controller is long-lived, so per-request latency
    # samples and per-drain records are ring-buffered (quantiles read the
    # most recent window; counts/means stay exact via running aggregates)
    metrics_window: int = 65536
    history_window: int = 4096
    # per-priority-class default deadlines (index clamped to the last entry)
    default_deadlines: Tuple[float, ...] = (0.25, 2.0)

    def __post_init__(self) -> None:
        if self.policy not in ("adaptive", "greedy", "fixed"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.fairness not in ("round_robin", "fifo"):
            raise ValueError(f"unknown fairness {self.fairness!r}")
        if self.service_model not in ("occupancy", "measured"):
            raise ValueError(f"unknown service_model {self.service_model!r}")
        if self.per_shard_aimd and (
            self.policy != "adaptive" or self.fairness != "round_robin"
        ):
            raise ValueError(
                "per_shard_aimd needs policy='adaptive' and "
                "fairness='round_robin' (per-shard targets are AIMD state "
                "over per-origin queues)"
            )

    def deadline_for(self, priority: int) -> float:
        # clamp both ways: negative (more-urgent-than-interactive) classes
        # take the tightest default, not a Python negative index
        idx = min(max(priority, 0), len(self.default_deadlines) - 1)
        return float(self.default_deadlines[idx])


@dataclasses.dataclass
class BatchRecord:
    """Telemetry for one drain (the adaptive loop's observable)."""

    t_dispatch: float
    size: int
    target: int  # batch target when the batch was formed
    compute_s: float  # router occupancy charged
    straggler_s: float  # max measured RouteResult.latency_s in the batch
    misses: int  # deadline misses produced by this drain


class AdmissionController:
    """Event-loop scheduler between :class:`StoreClient` and the store.

    Only ``store.serve_batch`` is required of the data plane.  All state is
    deterministic under the simulated clock; ``run_until_idle`` is the
    drive-to-completion entry (the old ``flush()``), ``step()`` the
    single-event one.
    """

    def __init__(self, store, config: Optional[AdmissionConfig] = None,
                 clock: Optional[SimClock] = None, policy=None,
                 tracer: Optional[Tracer] = None, registry=None,
                 wall_clock: Optional[Callable[[], float]] = None) -> None:
        self.store = store
        self.cfg = config or AdmissionConfig()
        self.clock = clock or SimClock()
        # fallback duration source for service_model="measured" when the
        # store reports no serve time.  Injected (sim-clock purity, GL002):
        # the default is a *reference* to the monotonic clock — tests pass a
        # fake to keep measured-mode runs deterministic.
        self._wall_clock = wall_clock if wall_clock is not None else time.perf_counter
        self.policy = policy  # optional MaintenancePolicy
        # control-plane spans run on the *simulated* clock: two identical
        # runs produce byte-identical trace exports.  An attached policy
        # without its own tracer shares this one, so migration waves land on
        # the same timeline as the request spans they interleave with.
        self.tracer = tracer if tracer is not None else Tracer(clock=self.clock.now)
        self._registry = registry
        if policy is not None and getattr(policy, "tracer", None) is None:
            policy.tracer = self.tracer
        self.batch_target = int(
            min(max(self.cfg.initial_batch, self.cfg.min_batch), self.cfg.max_batch)
        )
        # sharded data plane hooks (both optional; a plain GeoGraphStore has
        # neither): origin->shard mapping routes per-shard batch formation,
        # and the store's straggler detector feeds miss-cause attribution
        self._origin_shard: Optional[Dict[int, int]] = getattr(
            store, "origin_shard", None
        )
        self._straggler_det = getattr(store, "straggler", None)
        self._targets: Dict[int, int] = {}  # shard -> AIMD target
        self._lat_windows: Dict[int, Deque[float]] = {}  # shard -> p99 window
        self._shard_rr = 0
        self.straggler_misses_by_shard: Dict[int, int] = {}
        self._next_rid = 0
        self._arrival_seq = 0
        self._arrivals: List[Tuple[float, int, RequestHandle]] = []  # heap
        self._fifo: Deque[RequestHandle] = deque()
        self._queues: Dict[Tuple[int, int], Deque[RequestHandle]] = {}
        self._rr_pos: Dict[object, int] = {}
        self._n_pending = 0
        self._lat_window: Deque[float] = deque(maxlen=self.cfg.latency_window)
        self._latencies: Deque[float] = deque(maxlen=self.cfg.metrics_window)
        self._lat_sum = 0.0
        self._t_first_submit = math.inf
        self._t_last_done = 0.0
        self.completed = 0
        self.deadline_misses = 0
        # every miss is attributed to exactly one cause (the first stage
        # whose cumulative time blew the deadline), so the three counts
        # always sum to ``deadline_misses``
        self.misses_by_cause: Dict[str, int] = {
            "queue": 0, "service": 0, "straggler": 0
        }
        self.served_by_origin: Dict[int, int] = {}
        self._lat_by_origin: Dict[int, Deque[float]] = {}
        self.history: Deque[BatchRecord] = deque(maxlen=self.cfg.history_window)
        self._n_batches = 0
        self._batch_size_sum = 0
        # compaction renumbers item rows; subscribing to the store's remap
        # hook keeps in-flight handles valid, which in turn makes it safe to
        # let the maintenance policy compact during idle gaps
        self._remap_registered = False
        register = getattr(store, "add_remap_listener", None)
        if callable(register):
            register(self._remap_pending_items)
            self._remap_registered = True
        # the store's demand plane windows on this scheduler's clock; total
        # idle time is what pre-staging can hide migration work inside
        self._demand = getattr(store, "demand", None)
        self.idle_s = 0.0

    def _remap_pending_items(self, imap: np.ndarray) -> None:
        """Re-key every unserved handle's item rows after a compaction
        (dropped rows vanish from the request, like they do from patterns)."""
        pending = list(self._fifo)
        pending += [h for q in self._queues.values() for h in q]
        pending += [h for _, _, h in self._arrivals]
        for h in pending:
            it = imap[h.items]
            h.items = it[it >= 0]

    # ------------------------------------------------------------ admission
    def submit(
        self,
        items: np.ndarray,
        origin: int,
        deadline_s: Optional[float] = None,
        priority: int = 0,
        at: Optional[float] = None,
    ) -> RequestHandle:
        """Register one request; ``at`` schedules a future arrival (trace
        replay), otherwise the request arrives now."""
        t = self.clock.now() if at is None else float(at)
        h = RequestHandle(
            rid=self._next_rid,
            items=np.asarray(items),
            origin=int(origin),
            priority=int(priority),
            deadline_s=(
                self.cfg.deadline_for(int(priority)) if deadline_s is None
                else float(deadline_s)
            ),
            t_submit=t,
        )
        self._next_rid += 1
        self._t_first_submit = min(self._t_first_submit, t)
        if t <= self.clock.now():
            self._enqueue(h)
        else:
            self._arrival_seq += 1
            heapq.heappush(self._arrivals, (t, self._arrival_seq, h))
        return h

    def _enqueue(self, h: RequestHandle) -> None:
        if self.cfg.fairness == "fifo":
            self._fifo.append(h)
        else:
            self._queues.setdefault((h.priority, h.origin), deque()).append(h)
        self._n_pending += 1

    def _admit_due(self) -> int:
        n = 0
        while self._arrivals and self._arrivals[0][0] <= self.clock.now():
            _, _, h = heapq.heappop(self._arrivals)
            self._enqueue(h)
            n += 1
        return n

    @property
    def pending(self) -> int:
        """Admitted-but-unserved requests (future arrivals excluded)."""
        return self._n_pending

    @property
    def n_scheduled(self) -> int:
        """Future arrivals not yet admitted."""
        return len(self._arrivals)

    def pending_handles(self) -> List[RequestHandle]:
        """Admitted pending requests in drain order (FIFO) / rid order."""
        if self.cfg.fairness == "fifo":
            return list(self._fifo)
        out = [h for q in self._queues.values() for h in q]
        out.sort(key=lambda h: h.rid)
        return out

    # ------------------------------------------------------ batch formation
    def _target_size(self) -> int:
        if self.cfg.policy == "adaptive":
            return self.batch_target
        return self.cfg.max_batch

    def _shard_of(self, origin: int) -> int:
        """Shard owning an origin DC; without a sharded store every origin
        is its own 'shard' (degenerates to per-origin AIMD)."""
        if self._origin_shard is None:
            return origin
        return self._origin_shard.get(origin, origin)

    def _next_shard_key(self) -> Optional[int]:
        """Round-robin over shards that currently have pending requests."""
        keys = sorted(
            {self._shard_of(o) for (_, o), q in self._queues.items() if q}
        )
        if not keys:
            return None
        key = keys[self._shard_rr % len(keys)]
        self._shard_rr += 1
        return key

    def _form_batch(
        self, cap: int, shard_key: Optional[int] = None
    ) -> List[RequestHandle]:
        batch: List[RequestHandle] = []
        if self.cfg.fairness == "fifo":
            while self._fifo and len(batch) < cap:
                batch.append(self._fifo.popleft())
        else:
            prios = sorted({
                p for (p, o), q in self._queues.items()
                if q and (shard_key is None or self._shard_of(o) == shard_key)
            })
            for prio in prios:
                if len(batch) >= cap:
                    break
                origins = sorted({
                    o for (p, o), q in self._queues.items()
                    if p == prio and q
                    and (shard_key is None or self._shard_of(o) == shard_key)
                })
                if not origins:
                    continue
                cursor = prio if shard_key is None else (prio, shard_key)
                start = self._rr_pos.get(cursor, 0) % len(origins)
                while len(batch) < cap:
                    progressed = False
                    for i in range(len(origins)):
                        o = origins[(start + i) % len(origins)]
                        q = self._queues.get((prio, o))
                        take = min(self.cfg.quantum, cap - len(batch), len(q) if q else 0)
                        for _ in range(take):
                            batch.append(q.popleft())
                        progressed = progressed or take > 0
                        if len(batch) >= cap:
                            break
                    if not progressed:
                        break
                # rotate the cursor so the next batch starts one origin over
                self._rr_pos[cursor] = start + 1
        self._n_pending -= len(batch)
        return batch

    def _requeue(self, batch: List[RequestHandle]) -> None:
        """Put an unserved batch back at the queue fronts, order intact."""
        if self.cfg.fairness == "fifo":
            self._fifo.extendleft(reversed(batch))
        else:
            for h in reversed(batch):
                self._queues.setdefault((h.priority, h.origin), deque()).appendleft(h)
        self._n_pending += len(batch)

    # ------------------------------------------------------------ event loop
    def step(self) -> List[RequestHandle]:
        """One scheduler event; returns the requests completed by it.

        Guaranteed progress: either a batch is served, or the clock jumps to
        the next scheduled arrival (idle gaps are first offered to the
        attached maintenance policy).  Returns ``[]`` with nothing pending
        and nothing scheduled.

        With an enabled ``registry`` injected, each step adds its host
        seconds on the wall clock to ``controller.admit_s`` (admission and
        the demand plane's window advance), ``controller.form_s`` (the
        target, the batch and the request list handed to ``serve_batch``)
        and ``controller.book_s`` (everything after ``serve_batch``
        returns)."""
        reg = self._registry
        timed = reg is not None and reg.enabled
        if timed:
            t_step = self._wall_clock()
        self._admit_due()
        if self._demand is not None:
            self._demand.advance_to(self.clock.now())
        if timed:
            t_admitted = self._wall_clock()
            reg.counter("controller.admit_s").inc(t_admitted - t_step)
        shard_key: Optional[int] = None
        if self.cfg.per_shard_aimd and self._n_pending:
            shard_key = self._next_shard_key()
        if shard_key is not None:
            target = self._targets.get(shard_key, self.batch_target)
        else:
            target = self._target_size()
        waiting_to_fill = (
            self.cfg.policy == "fixed"
            and self._n_pending < target
            and self._arrivals
        )
        if self._n_pending == 0 or waiting_to_fill:
            if not self._arrivals:
                if self._n_pending == 0:
                    return []
            else:
                t_next = self._arrivals[0][0]
                gap = t_next - self.clock.now()
                if self.policy is not None and gap > 0 and self._n_pending == 0:
                    # maintenance runs inside the gap; any overrun is
                    # absorbed (the jump below caps the clock at t_next, so
                    # serving is never pushed back).  Compaction is allowed
                    # only when the remap hook keeps the scheduled handles'
                    # item rows valid across the renumbering.
                    self.policy.on_idle(
                        self.clock.now(), gap, quiescent=self._remap_registered
                    )
                if gap > 0:
                    self.idle_s += gap
                self.clock.jump_to(t_next)
                self._admit_due()
                return []
        batch = self._form_batch(target, shard_key=shard_key)
        requests = [(h.items, h.origin) for h in batch]
        t0 = self.clock.now()
        t_wall = self._wall_clock()
        try:
            results = self.store.serve_batch(requests)
        except BaseException:
            # nothing served, nothing lost: the whole batch returns to the
            # queue fronts and the next step retries it
            self._requeue(batch)
            raise
        if timed:
            t_served = self._wall_clock()
            reg.counter("controller.form_s").inc(t_wall - t_admitted)
        if self.cfg.service_model == "measured":
            measured = getattr(self.store, "last_serve_seconds", None)
            compute_s = (
                float(measured)
                if measured is not None
                else (t_served if timed else self._wall_clock()) - t_wall
            )
        else:
            compute_s = (
                self.cfg.dispatch_overhead_s
                + len(batch) * self.cfg.per_request_s
            )
        straggler = max((r.latency_s for r in results), default=0.0)
        t_done = t0 + compute_s + straggler
        bid = self._n_batches
        traced = self.tracer.enabled
        if traced:
            self.tracer.record(
                "drain", t0, t0 + compute_s, track="scheduler",
                batch=bid, size=len(batch), target=target,
            )
        misses = 0
        for h, r in zip(batch, results):
            h.result = r
            h.t_dispatch = t0
            h.t_done = t_done
            self._lat_window.append(h.latency_s)
            self._latencies.append(h.latency_s)
            self._lat_sum += h.latency_s
            self._lat_by_origin.setdefault(
                h.origin, deque(maxlen=self.cfg.metrics_window)
            ).append(h.latency_s)
            if h.deadline_missed:
                misses += 1
                self.misses_by_cause[self._miss_cause(h, t0, compute_s)] += 1
            self.served_by_origin[h.origin] = self.served_by_origin.get(h.origin, 0) + 1
            if traced:
                root = self.tracer.record(
                    "request", h.t_submit, t_done, track="requests",
                    rid=h.rid, origin=h.origin, priority=h.priority, batch=bid,
                )
                self.tracer.record(
                    "queue", h.t_submit, t0, track="requests", parent=root,
                    origin=h.origin,
                )
                self.tracer.record(
                    "route", t0, t0 + compute_s, track="requests", parent=root,
                    origin=h.origin,
                )
                self.tracer.record(
                    "wan_fetch", t0 + compute_s, t_done, track="requests",
                    parent=root, origin=h.origin,
                    layers=r.layers_used, dcs=len(r.dcs),
                )
        self.completed += len(batch)
        self.deadline_misses += misses
        self._t_last_done = max(self._t_last_done, t_done)
        self.history.append(BatchRecord(
            t_dispatch=t0, size=len(batch), target=target,
            compute_s=compute_s, straggler_s=straggler, misses=misses,
        ))
        self._n_batches += 1
        self._batch_size_sum += len(batch)
        self.clock.advance(compute_s)  # fetches overlap the next drain
        self._update_target(batch)
        if timed:
            reg.counter("controller.book_s").inc(self._wall_clock() - t_served)
        return batch

    def _miss_cause(self, h: RequestHandle, t0: float, compute_s: float) -> str:
        """Attribute a deadline miss to the first stage that overran.

        ``queue``: the request was already late when dispatched;
        ``service``: dispatch + router occupancy alone blew the deadline;
        ``straggler``: only the batch's slowest WAN fetch pushed it over.
        The stages partition every miss, so cause counts sum exactly to
        ``deadline_misses``.

        With a sharded store, a service-stage overrun whose owning shard is
        flagged by the store's :class:`StragglerDetector` is attributed as a
        ``straggler`` too — the router wasn't slow in general, that shard
        was — and either way a flagged shard's misses are tallied per shard
        in ``straggler_misses_by_shard``."""
        if t0 - h.t_submit > h.deadline_s:
            return "queue"
        det = self._straggler_det
        shard = self._shard_of(h.origin)
        lagging = det is not None and det.is_straggler(shard)
        if (t0 + compute_s) - h.t_submit > h.deadline_s and not lagging:
            return "service"
        if lagging:
            self.straggler_misses_by_shard[shard] = (
                self.straggler_misses_by_shard.get(shard, 0) + 1
            )
        return "straggler"

    def _update_target(self, batch: List[RequestHandle]) -> None:
        """AIMD on measured latency vs deadline slack (adaptive policy).

        With ``per_shard_aimd`` every drain is single-shard, so the update
        lands on that shard's own target (seeded from the global one)."""
        if self.cfg.policy != "adaptive" or not batch:
            return
        if self.cfg.per_shard_aimd:
            key = self._shard_of(batch[0].origin)
            # the p99 growth gate reads this shard's own window: a slow
            # shard's tail must not freeze the healthy shards' growth
            win = self._lat_windows.setdefault(
                key, deque(maxlen=self.cfg.latency_window)
            )
            win.extend(h.latency_s for h in batch)
            cur = self._targets.get(key, self.batch_target)
            self._targets[key] = self._aimd_next(cur, batch, win)
        else:
            self.batch_target = self._aimd_next(
                self.batch_target, batch, self._lat_window
            )

    def _aimd_next(
        self, cur: int, batch: List[RequestHandle], window: Deque[float]
    ) -> int:
        cfg = self.cfg
        if any(h.deadline_missed for h in batch):
            return max(cfg.min_batch, int(cur * cfg.shrink))
        grow = min(cfg.max_batch, max(cur + 1, int(cur * cfg.growth)))
        bounded = [h for h in batch if math.isfinite(h.deadline_s)]
        if not bounded:
            # no deadline pressure: amortize overhead as hard as allowed
            return grow
        tightest = min(h.deadline_s for h in bounded)
        slack = min(h.deadline_s - h.latency_s for h in bounded)
        p99 = float(np.quantile(np.asarray(window), 0.99))
        # grow while the marginal p99 stays inside the deadline slack band
        if slack > cfg.slack_frac * tightest and p99 <= (1.0 - cfg.slack_frac) * tightest:
            return grow
        return cur

    def run_until_idle(self, max_steps: int = 1_000_000) -> List[RequestHandle]:
        """Drain every pending and scheduled request; returns completions in
        completion order (the retired frontend's ``flush`` contract)."""
        done: List[RequestHandle] = []
        for _ in range(max_steps):
            if self._n_pending == 0 and not self._arrivals:
                return done
            done.extend(self.step())
        raise RuntimeError(f"run_until_idle did not converge in {max_steps} steps")

    # -------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, object]:
        lat = np.asarray(self._latencies, dtype=np.float64)
        span = self._t_last_done - (
            self._t_first_submit if math.isfinite(self._t_first_submit) else 0.0
        )
        out = {
            "completed": self.completed,
            "deadline_misses": self.deadline_misses,
            "misses_by_cause": dict(self.misses_by_cause),
            # quantiles over the (ring-buffered) most recent metrics_window
            "p50_s": float(np.quantile(lat, 0.50)) if len(lat) else 0.0,
            "p99_s": float(np.quantile(lat, 0.99)) if len(lat) else 0.0,
            "p99_by_origin": {
                o: float(np.quantile(np.asarray(w, dtype=np.float64), 0.99))
                for o, w in sorted(self._lat_by_origin.items())
            },
            "mean_s": self._lat_sum / self.completed if self.completed else 0.0,
            "throughput_rps": self.completed / span if span > 0 else 0.0,
            "n_batches": self._n_batches,
            "mean_batch": (
                self._batch_size_sum / self._n_batches if self._n_batches else 0.0
            ),
            "batch_target": self.batch_target,
            "served_by_origin": dict(sorted(self.served_by_origin.items())),
            "sim_time_s": self.clock.now(),
            "idle_s": self.idle_s,
        }
        if self.cfg.per_shard_aimd:
            out["batch_target_by_shard"] = dict(sorted(self._targets.items()))
        if self._straggler_det is not None:
            out["straggler_shards"] = self._straggler_det.flagged()
            out["straggler_misses_by_shard"] = dict(
                sorted(self.straggler_misses_by_shard.items())
            )
        return out
