"""Bandwidth-aware replica migration: vectorized planning, link-granular
transfer scheduling, wave-ordered application.

After a churn batch shifts the DHD equilibrium, the placement is stale in two
directions: newly-hot items are missing replicas near their readers, and
previously-hot replicas have gone cold.  The subsystem turns the heat field
into a move-set and the move-set into a WAN transfer pipeline:

  1. **Planning** (:func:`plan_migrations`) — drop and add benefits are
     masked ``[K, D]`` matrix reductions (the Eq. 13 surrogate at item
     granularity):

       * **adds** — hot items (heat >= the ``theta_add`` quantile) gain a
         replica at requesting DCs where the per-window read saving beats the
         added storage + write-sync cost; each add ships ``size`` bytes over
         the WAN from its nearest current replica.
       * **drops** — cold replicas (heat < ``theta_drop`` of the max) that
         are neither the primary copy, nor the sole replica, nor read
         locally, are released for free.

     Adds are taken greedily by benefit-per-WAN-byte under ``budget_bytes``
     (the paper's migration condition ξ, Eq. 14, as a global byte budget).
     The original per-item Python loops survive as ``vectorized=False`` —
     the differential reference the matrix path is held to, move for move
     (``tests/test_migration_pipeline.py``).
  2. **Scheduling** (:func:`schedule_transfers`) — accepted adds become
     per-``(src, dst)`` :class:`TransferBatch`es; the source is the nearest
     current replica (the ``route[x, dst]`` entry the read saving was priced
     against, falling back to the primary).  Batches are packed into
     :class:`TransferWave`s under **per-link** byte budgets
     ``env.bw_Bps * window_s`` (Table I): within a wave each link carries at
     most one migration window's worth of bytes, links run concurrently, and
     the pipelined makespan estimate is
     ``sum over waves of max over active links (bytes / bw + rtt)``.
  3. **Application** (:func:`apply_plan` with a schedule) — waves land in
     order, each patching ``state.delta`` and the :class:`RouteIndex` before
     the next begins, so the route table is wave-boundary consistent and a
     frontend can serve between waves (``on_wave``).  Drops are released only
     after every transfer lands (readers keep their replica until the
     replacement exists) and are rolled back wholesale if the Eq. 6
     constraint check regresses — a plan never turns a previously satisfied
     constraint into a violation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.cost import PlacementState, check_constraints
from ..core.latency import GeoEnvironment
from ..core.route_index import RouteIndex

__all__ = [
    "Move",
    "MigrationPlan",
    "TransferBatch",
    "TransferWave",
    "MigrationSchedule",
    "StaleFlushError",
    "plan_migrations",
    "schedule_transfers",
    "apply_plan",
    "WaveApplier",
]


class StaleFlushError(RuntimeError):
    """The item id space changed under an in-flight flush (mutation batch or
    compaction since ``begin_flush``); the remaining waves reference stale
    rows and must be re-planned.  Adds already applied are safe — they only
    widened replica sets in the pre-change id space and were remapped with
    everything else — and drops were never released."""


@dataclasses.dataclass
class Move:
    item: int
    dc: int
    kind: str  # "add" | "drop"
    benefit: float  # $/window cost saving (surrogate)
    wan_bytes: float  # bytes shipped to realize the move
    src: int = -1  # adds: nearest current replica the bytes ship from


@dataclasses.dataclass
class MigrationPlan:
    moves: List[Move]
    wan_bytes: float
    est_benefit: float
    n_candidates: int
    skipped_budget: int  # adds skipped (byte budget exhausted or move cap)
    rolled_back: int = 0  # drops reverted by the constraint guard
    schedule: Optional["MigrationSchedule"] = None  # set by flush_migrations

    @property
    def n_adds(self) -> int:
        return sum(1 for m in self.moves if m.kind == "add")

    @property
    def n_drops(self) -> int:
        return sum(1 for m in self.moves if m.kind == "drop")


def _primary_dcs(g) -> np.ndarray:
    return np.concatenate([g.partition, g.partition[g.src]]).astype(np.int64)


# ---------------------------------------------------------------- planning
def plan_migrations(
    g,
    env: GeoEnvironment,
    state: PlacementState,
    r_xy: np.ndarray,
    w_xy: np.ndarray,
    item_heat: np.ndarray,
    budget_bytes: float,
    theta_add: float = 0.80,
    theta_drop: float = 0.05,
    max_moves: int = 1024,
    item_alive: Optional[np.ndarray] = None,
    vectorized: bool = True,
) -> MigrationPlan:
    """Propose a move-set; pure planning, no state mutation.

    ``vectorized=False`` runs the per-item reference implementation; the
    default matrix path produces the identical move-set (same candidates,
    same benefits, same greedy order) at ~array speed.
    """
    if not vectorized:
        return _plan_migrations_legacy(
            g, env, state, r_xy, w_xy, item_heat, budget_bytes,
            theta_add, theta_drop, max_moves, item_alive,
        )
    sizes = g.item_size()
    I, D = r_xy.shape
    alive = (
        np.ones(I, dtype=bool) if item_alive is None else np.asarray(item_alive, bool)
    )
    primary = _primary_dcs(g)
    heat = np.asarray(item_heat, np.float64)
    hmax = float(heat[alive].max(initial=0.0))
    moves: List[Move] = []
    n_cand = 0

    # ------------------------------------------------------------- drops
    if hmax > 0:
        cold = alive & (heat < theta_drop * hmax)
    else:
        cold = np.zeros(I, dtype=bool)
    n_replicas = state.delta.sum(axis=1)
    cold_items = np.where(cold & (n_replicas > 1))[0]
    if len(cold_items):
        K = len(cold_items)
        # only replicas no origin currently reads from are free to drop — a
        # replica serving remote origins would push their reads to a farther
        # DC, a read-cost increase the drop benefit doesn't model.
        # serving[k, d] <=> exists y with r_xy[x, y] > 0 and route[x, y] == d
        routes = state.route[cold_items]  # [K, D]
        kk, yy = np.nonzero(r_xy[cold_items] > 0)
        rt = routes[kk, yy]
        ok = rt >= 0
        serving = np.zeros((K, D), dtype=bool)
        serving[kk[ok], rt[ok]] = True
        elig = state.delta[cold_items].copy()
        elig[np.arange(K), primary[cold_items]] = False
        elig &= ~serving
        kd, dd = np.nonzero(elig)  # (k asc, d asc) == reference loop order
        n_cand += len(kd)
        if len(kd):
            xc = cold_items[kd]
            # benefit[x, d] = s_x * c_store_d + sum_y w_xy * (c_put_d +
            # s_x * c_net[y, d]) — associated exactly like the reference so
            # the float64 results (and thus sort order) are bit-identical
            inner = env.c_write[dd][:, None] + sizes[xc][:, None] * env.c_net.T[dd]
            ben = sizes[xc] * env.c_store[dd] + (w_xy[xc] * inner).sum(axis=1)
            order = np.argsort(-ben, kind="stable")  # stable desc == reference
            for i in order[: max_moves // 2]:
                moves.append(Move(int(xc[i]), int(dd[i]), "drop", float(ben[i]), 0.0))

    # -------------------------------------------------------------- adds
    pos = heat[alive & (heat > 0)]
    theta = float(np.quantile(pos, theta_add)) if len(pos) else np.inf
    hot_items = np.where(alive & (heat >= theta) & (heat > 0))[0]
    wan = 0.0
    skipped = 0
    if len(hot_items):
        elig = (r_xy[hot_items] > 0) & ~state.delta[hot_items]
        hk, hd = np.nonzero(elig)
        n_cand += len(hk)
        if len(hk):
            xa = hot_items[hk]
            cur = state.route[xa, hd].astype(np.int64)
            cur = np.where(cur >= 0, cur, primary[xa])  # nearest replica / primary
            read_save = r_xy[xa, hd] * sizes[xa] * env.c_net[cur, hd]
            store_add = sizes[xa] * env.c_store[hd]
            inner = env.c_write[hd][:, None] + sizes[xa][:, None] * env.c_net.T[hd]
            write_add = (w_xy[xa] * inner).sum(axis=1)
            ben = read_save - store_add - write_add
            keep = ben > 0
            xa, hd, cur, ben = xa[keep], hd[keep], cur[keep], ben[keep]
            wb = sizes[xa].astype(np.float64)
            # greedy knapsack by benefit density under the WAN byte budget;
            # stable descending argsort == the reference's stable sort
            order = np.argsort(-(ben / np.maximum(wb, 1e-9)), kind="stable")
            slots = max_moves - len(moves)
            n_acc = 0
            for i in order:
                if n_acc >= slots:
                    skipped += 1
                    continue
                if wan + wb[i] > budget_bytes:
                    skipped += 1
                    continue
                wan += float(wb[i])
                n_acc += 1
                moves.append(
                    Move(int(xa[i]), int(hd[i]), "add", float(ben[i]),
                         float(wb[i]), src=int(cur[i]))
                )

    return MigrationPlan(
        moves=moves,
        wan_bytes=wan,
        est_benefit=float(sum(m.benefit for m in moves)),
        n_candidates=n_cand,
        skipped_budget=skipped,
    )


def _plan_migrations_legacy(
    g,
    env: GeoEnvironment,
    state: PlacementState,
    r_xy: np.ndarray,
    w_xy: np.ndarray,
    item_heat: np.ndarray,
    budget_bytes: float,
    theta_add: float = 0.80,
    theta_drop: float = 0.05,
    max_moves: int = 1024,
    item_alive: Optional[np.ndarray] = None,
) -> MigrationPlan:
    """Per-item reference planner (the pre-pipeline implementation)."""
    sizes = g.item_size()
    I, D = r_xy.shape
    alive = (
        np.ones(I, dtype=bool) if item_alive is None else np.asarray(item_alive, bool)
    )
    primary = _primary_dcs(g)
    heat = np.asarray(item_heat, np.float64)
    hmax = float(heat[alive].max(initial=0.0))
    moves: List[Move] = []
    n_cand = 0

    # ------------------------------------------------------------- drops
    if hmax > 0:
        cold = alive & (heat < theta_drop * hmax)
    else:
        cold = np.zeros(I, dtype=bool)
    n_replicas = state.delta.sum(axis=1)
    drop_cands: List[Move] = []
    for x in np.where(cold & (n_replicas > 1))[0]:
        serving = np.unique(state.route[x][r_xy[x] > 0])
        for d in np.where(state.delta[x])[0]:
            d = int(d)
            if d == primary[x] or d in serving:
                continue
            n_cand += 1
            benefit = float(sizes[x]) * float(env.c_store[d]) + float(
                (w_xy[x] * (env.c_write[d] + sizes[x] * env.c_net[:, d])).sum()
            )
            drop_cands.append(Move(int(x), d, "drop", benefit, 0.0))
    # keep the move-set minimal: highest-value drops first, at most half the
    # cap so adds keep room in the move-set
    drop_cands.sort(key=lambda m: m.benefit, reverse=True)
    moves.extend(drop_cands[: max_moves // 2])

    # -------------------------------------------------------------- adds
    pos = heat[alive & (heat > 0)]
    theta = float(np.quantile(pos, theta_add)) if len(pos) else np.inf
    hot = alive & (heat >= theta) & (heat > 0)
    add_cands: List[Move] = []
    for x in np.where(hot)[0]:
        sx = float(sizes[x])
        w_sync = w_xy[x]
        for d in np.where((r_xy[x] > 0) & ~state.delta[x])[0]:
            d = int(d)
            cur = int(state.route[x, d])
            if cur < 0:
                cur = int(primary[x])
            n_cand += 1
            read_save = float(r_xy[x, d]) * sx * float(env.c_net[cur, d])
            store_add = sx * float(env.c_store[d])
            write_add = float(
                (w_sync * (env.c_write[d] + sx * env.c_net[:, d])).sum()
            )
            benefit = read_save - store_add - write_add
            if benefit > 0:
                add_cands.append(Move(int(x), d, "add", benefit, sx, src=cur))

    # greedy knapsack by benefit density under the WAN byte budget
    add_cands.sort(key=lambda m: m.benefit / max(m.wan_bytes, 1e-9), reverse=True)
    wan = 0.0
    skipped = 0
    for m in add_cands:
        if len(moves) >= max_moves:
            skipped += 1
            continue
        if wan + m.wan_bytes > budget_bytes:
            skipped += 1
            continue
        wan += m.wan_bytes
        moves.append(m)

    return MigrationPlan(
        moves=moves,
        wan_bytes=wan,
        est_benefit=float(sum(m.benefit for m in moves)),
        n_candidates=n_cand,
        skipped_budget=skipped,
    )


# -------------------------------------------------------------- scheduling
@dataclasses.dataclass
class TransferBatch:
    """One link's payload inside one wave: items shipped ``src -> dst``."""

    src: int
    dst: int
    items: np.ndarray  # item ids, plan-priority order
    nbytes: float
    moves: List[Move]

    @property
    def n_transfers(self) -> int:
        return len(self.moves)


@dataclasses.dataclass
class TransferWave:
    """Concurrent link payloads; the wave ends when its slowest link does."""

    index: int
    links: List[TransferBatch]
    makespan_s: float  # max over links: nbytes / bw + rtt

    @property
    def nbytes(self) -> float:
        return float(sum(b.nbytes for b in self.links))

    @property
    def n_transfers(self) -> int:
        return sum(b.n_transfers for b in self.links)

    @property
    def moves(self) -> List[Move]:
        return [m for b in self.links for m in b.moves]


@dataclasses.dataclass
class MigrationSchedule:
    """Per-link packing of a plan's adds into bandwidth-bounded waves."""

    waves: List[TransferWave]
    window_s: float
    link_budget: np.ndarray  # [D, D] bytes one wave may ship per link
    local: List[Move]  # src == dst adds: nothing crosses the WAN
    makespan_s: float  # pipelined estimate: sum of wave makespans
    oversized: int = 0  # single transfers larger than their link budget
    packing: str = "ff"  # packing discipline that produced the waves

    @property
    def n_waves(self) -> int:
        return len(self.waves)

    @property
    def n_transfers(self) -> int:
        return sum(w.n_transfers for w in self.waves) + len(self.local)

    def link_loads(self) -> Dict[Tuple[int, int, int], float]:
        """(wave, src, dst) -> bytes; the budget-compliance surface under test."""
        return {
            (w.index, b.src, b.dst): b.nbytes for w in self.waves for b in w.links
        }


def _pack_link_ff(ms: List[Move], cap: float) -> Tuple[List[List[Move]], int]:
    """Sequential (next-fit) packing in plan-priority order: the current wave
    is closed as soon as a transfer does not fit, so within a link the highest
    benefit-density transfers always ship first."""
    bins: List[List[Move]] = []
    oversized = 0
    cur: List[Move] = []
    cur_bytes = 0.0
    for m in ms:
        if cur and cur_bytes + m.wan_bytes > cap:
            bins.append(cur)
            cur, cur_bytes = [], 0.0
        cur.append(m)
        cur_bytes += m.wan_bytes
        if cur_bytes > cap:  # lone transfer larger than the link budget
            oversized += 1
            bins.append(cur)
            cur, cur_bytes = [], 0.0
    if cur:
        bins.append(cur)
    return bins, oversized


def _pack_link_lpt(ms: List[Move], cap: float) -> Tuple[List[List[Move]], int]:
    """LPT / first-fit-decreasing packing: transfers sorted by bytes
    descending, each placed into the first wave with room.  Fewer, fuller
    waves -> fewer straggler roundtrips per link."""
    bins: List[List[Move]] = []
    loads: List[float] = []
    oversized = 0
    order = sorted(range(len(ms)), key=lambda i: (-ms[i].wan_bytes, i))
    for i in order:
        m = ms[i]
        if m.wan_bytes > cap:  # ships alone, flagged, like the ff path
            oversized += 1
            bins.append([m])
            loads.append(m.wan_bytes)
            continue
        for j in range(len(bins)):
            if loads[j] + m.wan_bytes <= cap and loads[j] <= cap:
                bins[j].append(m)
                loads[j] += m.wan_bytes
                break
        else:
            bins.append([m])
            loads.append(m.wan_bytes)
    return bins, oversized


def _assemble(
    plan_links: Dict[Tuple[int, int], List[List[Move]]],
    env: GeoEnvironment,
) -> Tuple[List[TransferWave], float]:
    """Zip per-link wave slots into global :class:`TransferWave`s."""
    waves_links: Dict[int, List[TransferBatch]] = {}
    for (s, d), bins in sorted(plan_links.items()):
        for wave_i, cur in enumerate(bins):
            waves_links.setdefault(wave_i, []).append(
                TransferBatch(
                    src=s, dst=d,
                    items=np.asarray([m.item for m in cur], dtype=np.int64),
                    nbytes=float(sum(m.wan_bytes for m in cur)),
                    moves=list(cur),
                )
            )
    waves: List[TransferWave] = []
    makespan = 0.0
    for w in sorted(waves_links):
        links = waves_links[w]
        span = max(
            b.nbytes / float(env.bw_Bps[b.src, b.dst]) + float(env.rtt_s[b.src, b.dst])
            for b in links
        )
        waves.append(TransferWave(index=len(waves), links=links, makespan_s=span))
        makespan += span
    return waves, makespan


def schedule_transfers(
    plan: MigrationPlan,
    env: GeoEnvironment,
    window_s: float,
    schedule: str = "ff",
) -> MigrationSchedule:
    """Pack a plan's adds into per-link :class:`TransferWave`s.

    Each accepted add ships ``wan_bytes`` over the WAN link
    ``(move.src, move.dc)``.  Per link, transfers are packed under the
    per-link byte budget ``env.link_budget_bytes(window_s)`` — a wave never
    carries more than one migration window's worth of bytes on any link,
    except for a single transfer that alone exceeds its link budget (shipped
    as its own, flagged-oversized wave rather than starving forever).  Links
    transfer concurrently within a wave; the makespan estimate per wave is
    the straggler link's ``nbytes / bw + rtt`` (Eq. 1 applied to the bulk
    payload), and the schedule's total is the sum over waves.

    ``schedule`` selects the packing discipline:

      * ``"ff"`` (default) — sequential first-fit in plan-priority order;
        the highest benefit-density transfers ship in the earliest waves.
      * ``"lpt"`` — makespan-aware longest-processing-time packing
        (first-fit-decreasing by bytes per link).  Fuller waves shave the
        straggler roundtrips first-fit leaves behind; the ff schedule is
        kept as a floor, so LPT is **never worse** than first-fit on the
        pipelined makespan estimate (the better of the two is returned).
    """
    if schedule not in ("ff", "lpt"):
        raise ValueError(f"unknown packing {schedule!r} (want 'ff' or 'lpt')")
    budget = env.link_budget_bytes(window_s)
    per_link: Dict[Tuple[int, int], List[Move]] = {}
    local: List[Move] = []
    for m in plan.moves:
        if m.kind != "add":
            continue
        src = int(m.src) if m.src >= 0 else int(m.dc)
        if src == m.dc:
            local.append(m)  # replica materializes from a co-located copy
            continue
        per_link.setdefault((src, int(m.dc)), []).append(m)

    def _build(packer, name: str) -> MigrationSchedule:
        plan_links: Dict[Tuple[int, int], List[List[Move]]] = {}
        oversized = 0
        for (s, d), ms in sorted(per_link.items()):
            bins, over = packer(ms, float(budget[s, d]))
            plan_links[(s, d)] = bins
            oversized += over
        waves, makespan = _assemble(plan_links, env)
        return MigrationSchedule(
            waves=waves,
            window_s=float(window_s),
            link_budget=budget,
            local=local,
            makespan_s=makespan,
            oversized=oversized,
            packing=name,
        )

    ff = _build(_pack_link_ff, "ff")
    if schedule == "ff":
        return ff
    lpt = _build(_pack_link_lpt, "lpt")
    # never worse than first-fit: ties keep ff (priority order preserved)
    return lpt if lpt.makespan_s < ff.makespan_s else ff


# ------------------------------------------------------------- application
def _reroute_items(
    state: PlacementState, env: GeoEnvironment, rows: np.ndarray
) -> None:
    """Partial Eq. 1 nearest-replica refresh for just ``rows``."""
    state.route_nearest(env, rows=np.asarray(rows))


def _refresh_routes(
    state: PlacementState,
    env: GeoEnvironment,
    route_index: Optional["RouteIndex"],
    rows: np.ndarray,
    moves=None,
) -> None:
    """Routing refresh after a replica-set delta — the one shared path for
    the single-shot, wave-by-wave and rollback cases."""
    if route_index is None:
        _reroute_items(state, env, rows)
    elif moves is not None:
        route_index.apply_moves(state.delta, moves)
    else:  # rollback: replica sets changed outside the move-set shape
        route_index.patch_rows(state.delta, rows)
    if route_index is not None:
        state.route = route_index.nearest


class WaveApplier:
    """Resumable wave-by-wave application of a scheduled plan.

    The one-shot :func:`apply_plan` drives this internally; a maintenance
    control plane (the serving control plane's ``MaintenancePolicy``) holds
    one across serving drains and applies waves into idle gaps one at a time.  The
    invariants are the same as the inline path: after every completed wave
    the placement and :class:`~repro_torch.core.route_index.RouteIndex` are
    mutually consistent, drops release only in :meth:`finish` (after the
    last transfer lands), and the Eq. 6 constraint guard rolls drops back
    wholesale if any previously-satisfied constraint regresses.

    Zero-byte local adds (co-located source) land at construction time —
    they cross no WAN link, so they never wait for a window.
    """

    def __init__(
        self,
        plan: MigrationPlan,
        state: PlacementState,
        env: GeoEnvironment,
        patterns: Sequence,
        r_xy: np.ndarray,
        sizes: np.ndarray,
        gamma_max_s: float,
        route_index: Optional["RouteIndex"] = None,
        valid_check: Optional[Callable[[], bool]] = None,
    ) -> None:
        if plan.schedule is None:
            raise ValueError("WaveApplier needs a scheduled plan (plan.schedule)")
        self.plan = plan
        self.schedule = plan.schedule
        self.state = state
        self.env = env
        self.patterns = patterns
        self.r_xy = r_xy
        self.sizes = sizes
        self.gamma_max_s = gamma_max_s
        self.route_index = route_index
        # id-space guard: begin_flush wires this to the store's epoch so a
        # mutation batch / compaction between waves raises StaleFlushError
        # instead of applying renumbered rows
        self.valid_check = valid_check
        self._before = check_constraints(
            patterns, state, r_xy, sizes, env, gamma_max_s
        )
        self._wave_i = 0
        self._finished = False
        if self.schedule.local:
            for m in self.schedule.local:
                state.delta[m.item, m.dc] = True
            self._refresh(
                np.unique([m.item for m in self.schedule.local]),
                moves=self.schedule.local,
            )

    def _refresh(self, rows: np.ndarray, moves=None) -> None:
        _refresh_routes(self.state, self.env, self.route_index, rows, moves)

    def _ensure_valid(self) -> None:
        if self.valid_check is not None and not self.valid_check():
            raise StaleFlushError(
                "item id space changed under this flush; re-plan the "
                f"remaining {self.n_remaining} waves"
            )

    def check_valid(self) -> None:
        """Raise :class:`StaleFlushError` if the id space moved under this
        flush — for wrappers (the sharded store's transfer proxy) that must
        refuse to ship payload for a wave whose rows are already stale."""
        self._ensure_valid()

    @property
    def n_remaining(self) -> int:
        return len(self.schedule.waves) - self._wave_i

    @property
    def done(self) -> bool:
        return self._finished

    def peek(self) -> Optional[TransferWave]:
        """The next wave to apply (None when all waves have landed)."""
        if self.n_remaining == 0:
            return None
        return self.schedule.waves[self._wave_i]

    def apply_next(self) -> TransferWave:
        """Land one wave: placement rows + route-index patch, in order."""
        self._ensure_valid()
        wave = self.schedule.waves[self._wave_i]
        self._wave_i += 1
        for b in wave.links:
            self.state.delta[b.items, b.dst] = True
        if self.route_index is not None:
            self.route_index.apply_grouped(
                self.state.delta, [(b.dst, "add", b.items) for b in wave.links]
            )
            self.state.route = self.route_index.nearest
        else:
            _reroute_items(
                self.state, self.env,
                np.unique(np.concatenate([b.items for b in wave.links])),
            )
        return wave

    def finish(self) -> Dict[str, bool]:
        """Release drops (every transfer has landed) + run the guard."""
        self._ensure_valid()
        if self.n_remaining:
            raise RuntimeError(f"{self.n_remaining} waves still pending")
        if self._finished:
            raise RuntimeError("finish() already ran")
        self._finished = True
        plan, state = self.plan, self.state
        drops = [m for m in plan.moves if m.kind == "drop"]
        if drops:
            for m in drops:
                state.delta[m.item, m.dc] = False
            self._refresh(np.unique([m.item for m in drops]), moves=drops)
        after = check_constraints(
            self.patterns, state, self.r_xy, self.sizes, self.env, self.gamma_max_s
        )
        if any(self._before[k] and not after[k] for k in self._before):
            touched = np.unique([m.item for m in plan.moves]).astype(np.int64)
            for m in drops:
                state.delta[m.item, m.dc] = True
            self._refresh(touched)
            plan.rolled_back = len(drops)
            plan.moves = [m for m in plan.moves if m.kind == "add"]
            plan.est_benefit = float(sum(m.benefit for m in plan.moves))
            after = check_constraints(
                self.patterns, state, self.r_xy, self.sizes, self.env,
                self.gamma_max_s,
            )
        return after


def apply_plan(
    plan: MigrationPlan,
    state: PlacementState,
    env: GeoEnvironment,
    patterns: Sequence,
    r_xy: np.ndarray,
    sizes: np.ndarray,
    gamma_max_s: float,
    route_index: Optional["RouteIndex"] = None,
    schedule: Optional[MigrationSchedule] = None,
    on_wave: Optional[Callable[[TransferWave], None]] = None,
) -> Dict[str, bool]:
    """Apply the plan with a constraint guard; returns the final check flags.

    Without a ``schedule`` the whole move-set lands at once (the legacy
    single-shot path).  With one, adds land **wave by wave** in schedule
    order through a :class:`WaveApplier`: each wave mutates ``state.delta``
    and patches the :class:`~repro_torch.core.route_index.RouteIndex` (or partially
    reroutes) before ``on_wave(wave)`` fires, so callers can serve requests
    between waves against a route table that is always consistent with the
    placement.  Drops are released only after the last transfer wave.

    Invariant: no constraint that held before application is violated after —
    adds only widen the replica sets, and drops are rolled back wholesale if
    the post-check regresses.
    """
    if schedule is not None:
        if plan.schedule is not schedule:
            plan.schedule = schedule
        wa = WaveApplier(
            plan, state, env, patterns, r_xy, sizes, gamma_max_s,
            route_index=route_index,
        )
        while wa.n_remaining:
            wave = wa.apply_next()
            if on_wave is not None:
                on_wave(wave)
        return wa.finish()

    before = check_constraints(patterns, state, r_xy, sizes, env, gamma_max_s)
    touched = np.unique([m.item for m in plan.moves]).astype(np.int64)
    for m in plan.moves:
        state.delta[m.item, m.dc] = m.kind == "add"
    _refresh_routes(state, env, route_index, touched, moves=plan.moves)
    after = check_constraints(patterns, state, r_xy, sizes, env, gamma_max_s)
    if any(before[k] and not after[k] for k in before):
        drops = [m for m in plan.moves if m.kind == "drop"]
        for m in drops:
            state.delta[m.item, m.dc] = True
        _refresh_routes(state, env, route_index, touched)
        plan.rolled_back = len(drops)
        plan.moves = [m for m in plan.moves if m.kind == "add"]
        plan.est_benefit = float(sum(m.benefit for m in plan.moves))
        after = check_constraints(patterns, state, r_xy, sizes, env, gamma_max_s)
    return after
