"""Exact solution of the joint placement/routing BIP (Eq. 6) on tiny instances.

The paper solves Eq. 6 with PuLP/CBC on WIKI-vote to report a 7.8% optimality
gap (Fig. 9).  CBC is not available offline, so we brute-force the same
optimum: enumerate per-item replica sets (delta rows) and route each request
optimally given delta; pattern costs decompose per pattern given routes.

Complexity is O(I * 2^D * D) per candidate assignment sweep with a
coordinate-descent outer loop (items are coupled only through C^(A), which
depends on pattern routing; we iterate item-wise exact improvement until a
fixed point — on the tiny instances used in tests/benchmarks this reaches
the enumerated global optimum, which we verify by full enumeration when
I * D <= 16).
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import numpy as np

from .cost import PlacementState, total_cost
from .latency import GeoEnvironment
from .patterns import Workload

__all__ = ["solve_exact_tiny", "solve_coordinate_descent"]


def _route_optimal(
    state: PlacementState, workload: Workload, env: GeoEnvironment, sizes: np.ndarray
) -> None:
    """Optimal routing given delta: nearest replica minimizes both Eq. 3's
    cross-DC cost and Eq. 1 latency (c_read uniform across DCs here)."""
    state.route_nearest(env)


def solve_exact_tiny(
    workload: Workload,
    env: GeoEnvironment,
    sizes: np.ndarray,
    primary: np.ndarray,  # [I] primary DC per item (fixed, always a replica)
    max_enum_items: int = 8,
    max_extra_replicas: int = 1,
) -> Tuple[PlacementState, float]:
    """Full enumeration over replica sets of the accessed items (bounded to
    ``max_extra_replicas`` extra copies per item to keep the product space
    tractable: (1 + D*extra)^items states)."""
    I = workload.n_items
    D = env.n_dcs
    accessed = np.where(workload.r_xy.sum(axis=1) + workload.w_xy.sum(axis=1) > 0)[0]
    if len(accessed) > max_enum_items:
        raise ValueError(
            f"{len(accessed)} accessed items > {max_enum_items}; use coordinate descent"
        )
    best_cost = np.inf
    best_state: Optional[PlacementState] = None
    # choice per item: subset of extra DCs to add replicas at
    subsets = list(itertools.chain.from_iterable(
        itertools.combinations(range(D), r)
        for r in range(min(max_extra_replicas, D - 1) + 1)
    ))
    for combo in itertools.product(range(len(subsets)), repeat=len(accessed)):
        state = PlacementState.empty(I, D)
        state.delta[np.arange(I), primary] = True
        for xi, ci in zip(accessed, combo):
            for d in subsets[ci]:
                state.delta[xi, d] = True
        _route_optimal(state, workload, env, sizes)
        c = total_cost(
            workload.patterns, state, workload.r_xy, workload.w_xy, sizes, env
        ).total
        if c < best_cost:
            best_cost = c
            best_state = state
    assert best_state is not None
    return best_state, float(best_cost)


def solve_coordinate_descent(
    workload: Workload,
    env: GeoEnvironment,
    sizes: np.ndarray,
    primary: np.ndarray,
    max_rounds: int = 6,
    seed: int = 0,
) -> Tuple[PlacementState, float]:
    """Item-wise exact improvement: for each accessed item enumerate all 2^D
    replica rows (primary forced), keep the row minimizing the exact global
    objective.  Converges to a strong local optimum of Eq. 6; used as the
    reference optimum on small graphs (paper Fig. 9 scale)."""
    I = workload.n_items
    D = env.n_dcs
    accessed = np.where(workload.r_xy.sum(axis=1) + workload.w_xy.sum(axis=1) > 0)[0]
    state = PlacementState.empty(I, D)
    state.delta[np.arange(I), primary] = True
    _route_optimal(state, workload, env, sizes)
    cur = total_cost(
        workload.patterns, state, workload.r_xy, workload.w_xy, sizes, env
    ).total
    rows = [np.array(bits) for bits in itertools.product([False, True], repeat=D)]
    rng = np.random.default_rng(seed)
    for _ in range(max_rounds):
        improved = False
        order = rng.permutation(accessed)
        for x in order.tolist():
            best_row = state.delta[x].copy()
            best_c = cur
            for row in rows:
                r = row.copy()
                r[primary[x]] = True
                if (r == state.delta[x]).all():
                    continue
                state.delta[x] = r
                _route_optimal(state, workload, env, sizes)
                c = total_cost(
                    workload.patterns, state, workload.r_xy, workload.w_xy, sizes, env
                ).total
                if c < best_c - 1e-12:
                    best_c = c
                    best_row = r.copy()
            state.delta[x] = best_row
            _route_optimal(state, workload, env, sizes)
            if best_c < cur - 1e-12:
                cur = best_c
                improved = True
        if not improved:
            break
    return state, float(cur)
