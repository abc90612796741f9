"""GeoLayer cost metrics and the joint optimization objective (paper §III).

Decision variables (Eq. 6):
  * ``delta[x, d]``  — item x has a replica at DC d           (placement)
  * ``route[x, y]``  — DC serving reads of x from origin y    (= sigma_xyd)
  * ``rho[p, y]``    — derived: set of DCs serving pattern p from y

Costs:  C^(S) Eq. 2, C^(R) Eq. 3, C^(W) Eq. 4, C^(A) Eq. 5.
Constraints (a)-(e) are checked by :func:`check_constraints`.
All heavy loops are vectorized NumPy; this is the control-plane oracle that
benchmarks and tests evaluate every strategy against.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .latency import GeoEnvironment

__all__ = [
    "PlacementState",
    "CostBreakdown",
    "storage_cost",
    "read_cost",
    "write_cost",
    "association_penalty",
    "pattern_latencies",
    "total_cost",
    "check_constraints",
]

_LAT_FLOOR_S = 1e-3  # guards Eq. 5's ratio when the min-latency DC is local


@dataclasses.dataclass
class PlacementState:
    """Placement + routing decisions for ``n_items`` over ``n_dcs``."""

    delta: np.ndarray  # [I, D] bool — replica map
    route: np.ndarray  # [I, D] int32 — serving DC of item x for origin y

    @staticmethod
    def empty(n_items: int, n_dcs: int) -> "PlacementState":
        return PlacementState(
            delta=np.zeros((n_items, n_dcs), dtype=bool),
            route=np.full((n_items, n_dcs), -1, dtype=np.int32),
        )

    def copy(self) -> "PlacementState":
        return PlacementState(self.delta.copy(), self.route.copy())

    def place(self, items: np.ndarray, dc: int) -> None:
        self.delta[np.asarray(items), dc] = True

    def route_nearest(
        self,
        env: GeoEnvironment,
        rows: Optional[np.ndarray] = None,
    ) -> None:
        """Route every (item, origin) to its latency-minimal replica (Eq. 1).

        The per-item size term is identical across candidate DCs, so RTT
        alone ranks them.  ``rows`` restricts the refresh to a subset of
        items — the streaming partial-reroute path after replica-set
        changes."""
        lat = env.rtt_s.copy()  # [d, y]; size term identical across d per item
        np.fill_diagonal(lat, 0.0)
        delta = self.delta if rows is None else self.delta[rows]
        if delta.shape[0] == 0:
            return
        big = np.where(delta[:, :, None], lat[None, :, :], np.inf)  # [I,d,y]
        route = np.argmin(big, axis=1).astype(np.int32)  # [I, y]
        route[~delta.any(axis=1)] = -1
        if rows is None:
            self.route = route
        else:
            self.route[rows] = route


@dataclasses.dataclass
class CostBreakdown:
    storage: float
    read: float
    write: float
    assoc: float

    @property
    def total(self) -> float:
        return self.storage + self.read + self.write + self.assoc

    def as_dict(self) -> Dict[str, float]:
        return dict(
            storage=self.storage, read=self.read, write=self.write,
            assoc=self.assoc, total=self.total,
        )


# ------------------------------------------------------------------ Eq. (2)
def storage_cost(state: PlacementState, sizes: np.ndarray, env: GeoEnvironment) -> float:
    return float((sizes[:, None] * state.delta * env.c_store[None, :]).sum())


# ------------------------------------------------------------------ Eq. (3)
def read_cost(
    state: PlacementState,
    r_xy: np.ndarray,  # [I, D] read frequency of item x from origin y
    sizes: np.ndarray,
    env: GeoEnvironment,
) -> float:
    I, D = r_xy.shape
    d = state.route  # [I, D]
    valid = d >= 0
    d_safe = np.where(valid, d, 0)
    get = env.c_read[d_safe]  # [I, D]
    ys = np.arange(D)[None, :]
    cross = (d_safe != ys) & valid
    net = np.where(cross, sizes[:, None] * env.c_net[d_safe, ys], 0.0)
    return float((r_xy * np.where(valid, get + net, 0.0)).sum())


# ------------------------------------------------------------------ Eq. (4)
def write_cost(
    state: PlacementState,
    w_xy: np.ndarray,  # [I, D]
    sizes: np.ndarray,
    env: GeoEnvironment,
) -> float:
    I, D = w_xy.shape
    # synchronization to every replica d != y:
    #   sum_d delta_xd * (c_write_d + s_x * c_net[y, d]), excluding d == y
    sync_put = state.delta @ env.c_write  # [I]
    own_put = state.delta * env.c_write[None, :]  # replica at y itself
    net_to = np.einsum("id,yd->iy", state.delta, env.c_net)  # [I, y]
    net_own = state.delta * np.diag(env.c_net)[None, :]
    sync = (sync_put[:, None] - own_put) + sizes[:, None] * (net_to - net_own)
    # Eq. 4: local PUT at the originating DC + replica synchronization
    return float((w_xy * (env.c_write[None, :] + sync)).sum())


# ------------------------------------------------------------------ Eq. (1)
def pattern_latencies(
    items: np.ndarray,
    origin: int,
    state: PlacementState,
    sizes: np.ndarray,
    env: GeoEnvironment,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-serving-DC latency l_yd^p for a pattern from ``origin``.

    Returns (serving_dcs, latencies).  S_d^p = total bytes of p's items that
    DC d serves for this origin (Eq. 1)."""
    d = state.route[items, origin]
    d = d[d >= 0]
    if len(d) == 0:
        return np.array([], dtype=np.int64), np.array([])
    dcs = np.unique(d)
    s_d = np.zeros(len(dcs))
    sz = sizes[items[state.route[items, origin] >= 0]]
    for i, dc in enumerate(dcs):
        s_d[i] = sz[d == dc].sum()
    lat = np.array(
        [env.request_latency(int(dc), origin, s) for dc, s in zip(dcs, s_d)]
    )
    return dcs, lat


# ------------------------------------------------------------------ Eq. (5)
def association_penalty(
    patterns: Sequence,  # of core.patterns.Pattern
    state: PlacementState,
    sizes: np.ndarray,
    env: GeoEnvironment,
    lambda1: float = 0.5,
    lambda2: float = 0.5,
) -> float:
    total = 0.0
    for p in patterns:
        for y in np.where(p.r_py > 0)[0]:
            dcs, lat = pattern_latencies(p.items, int(y), state, sizes, env)
            if len(dcs) == 0:
                continue
            n_extra = len(dcs) - 1
            # Delta-l over *remote* participants: local self-serving has ~0
            # latency and is not a WAN straggler candidate (deviation from a
            # literal Eq. 5 read, where a partially-local pattern would make
            # the ratio unbounded; documented in DESIGN.md).
            rem = lat[dcs != y]
            if len(rem) >= 2:
                lmin = max(float(rem.min()), _LAT_FLOOR_S)
                dl = (float(rem.max()) - float(rem.min())) / lmin
            else:
                dl = 0.0
            total += float(p.r_py[y]) * (lambda1 * n_extra + lambda2 * dl)
    return total


# ------------------------------------------------------------------ Eq. (6)
def total_cost(
    patterns: Sequence,
    state: PlacementState,
    r_xy: np.ndarray,
    w_xy: np.ndarray,
    sizes: np.ndarray,
    env: GeoEnvironment,
    lambda1: float = 0.5,
    lambda2: float = 0.5,
) -> CostBreakdown:
    return CostBreakdown(
        storage=storage_cost(state, sizes, env),
        read=read_cost(state, r_xy, sizes, env),
        write=write_cost(state, w_xy, sizes, env),
        assoc=association_penalty(patterns, state, sizes, env, lambda1, lambda2),
    )


def check_constraints(
    patterns: Sequence,
    state: PlacementState,
    r_xy: np.ndarray,
    sizes: np.ndarray,
    env: GeoEnvironment,
    gamma_max_s: float,
) -> Dict[str, bool]:
    """Constraints (a)-(e) of Eq. (6).  Returns per-constraint pass flags.

    ``r_xy`` is the demand table the placement is accountable to.  The
    pattern constraints (b) and (d) bind only at origins whose reads of the
    pattern exist in that table: with the offline workload's ``r_xy`` (built
    as the per-item sum of every pattern's ``r_py``) this is exactly the
    ``r_py > 0`` origin set, while an injected measured/forecast demand
    table frees origins with zero live traffic from the SLO — a replica
    nobody reads from must be droppable (Alg. 3), which a constraint pinned
    to retired synthetic reads would forbid forever."""
    I, D = r_xy.shape
    ok: Dict[str, bool] = {}
    routed = state.route >= 0
    # (a) sigma <= delta and exactly one serving DC per requested item
    r_safe = np.where(routed, state.route, 0)
    served_has_replica = np.where(
        routed, state.delta[np.arange(I)[:, None], r_safe], True
    )
    ok["a_route_on_replica"] = bool(served_has_replica.all())
    requested = r_xy > 0
    ok["a_requested_routed"] = bool((routed | ~requested).all())
    # (b) rho only on DCs holding all the referenced items' replicas
    ok_b = True
    for p in patterns:
        for y in np.where(p.r_py > 0)[0]:
            if not requested[p.items, y].any():
                continue  # no live demand for this pattern at y
            d = state.route[p.items, y]
            if (d < 0).any():
                ok_b = False
                break
            if not state.delta[p.items, d].all():
                ok_b = False
                break
    ok["b_pattern_route_on_replica"] = ok_b
    # (c) average read latency <= Gamma_max
    num = 0.0
    den = 0.0
    for y in range(D):
        d = state.route[:, y]
        m = (d >= 0) & requested[:, y]
        if not m.any():
            continue
        l = np.array(
            [env.request_latency(int(dd), y, float(sizes[x])) for x, dd in zip(np.where(m)[0], d[m])]
        )
        num += (r_xy[m, y] * l).sum()
        den += m.sum()
    ok["c_avg_latency"] = bool(den == 0 or num / max(den, 1) <= gamma_max_s)
    # (d) per-pattern straggler <= eta_p * Gamma_max
    ok_d = True
    for p in patterns:
        for y in np.where(p.r_py > 0)[0]:
            if not requested[p.items, y].any():
                continue  # no live demand for this pattern at y
            _, lat = pattern_latencies(p.items, int(y), state, sizes, env)
            if len(lat) and lat.max() > p.eta * gamma_max_s + 1e-12:
                ok_d = False
    ok["d_pattern_slo"] = ok_d
    ok["e_binary"] = True  # by construction of the dtypes
    return ok
