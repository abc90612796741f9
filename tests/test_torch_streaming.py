"""The port's streaming modules vs the JAX package's, on the CPU.

* ``DeltaGraph.apply`` / ``compact`` and the churn generator: the same
  seeded batches give identical ``ApplyResult`` arrays, graphs and id maps
  (the scenarios of ``tests/test_streaming.py``);
* ``StreamingHeat``: the warm-update scenarios of ``tests/test_streaming.py``
  plus one whose frontier takes the pre-solve, through both packages —
  ``WarmStats`` integers equal, heat within the DHD tolerance (atol 1e-5,
  rtol 1e-4, ``tests/test_kernels.py``);
* a field carried across with ``streaming_heat_from_numpy`` takes the same
  warm update in both packages.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.graph import Graph as JaxGraph
from repro.core.patterns import Workload as JaxWorkload
from repro.core.patterns import generate_khop_patterns as jax_khop
from repro.streaming import DeltaGraph as JaxDeltaGraph
from repro.streaming import MutationLog as JaxMutationLog
from repro.streaming import StreamingHeat as JaxStreamingHeat
from repro.streaming import compact_workload as jax_compact_workload
from repro.streaming import random_churn_batch as jax_churn
from repro_torch.convert import streaming_heat_arrays, streaming_heat_from_numpy
from repro_torch.core.graph import Graph, build_csr
from repro_torch.core.patterns import Workload
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
from repro_torch.streaming import (
    DeltaGraph,
    MutationLog,
    StreamingHeat,
    compact_workload,
    random_churn_batch,
)

DHD_TOL = dict(atol=1e-5, rtol=1e-4)


def _random_graph(G, n, m, n_dcs, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    return G.from_edges(
        n, src[keep], dst[keep], partition=rng.integers(0, n_dcs, n)
    ), rng


def _assert_graphs_equal(a, b):
    assert a.n_nodes == b.n_nodes
    for f in ("src", "dst", "node_size", "edge_size", "partition"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _assert_dataclass_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name


# ------------------------------------------------------------- delta overlay
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_graph_apply_and_compact_match_jax(seed):
    """Three churn batches from identically seeded generators: the batches,
    every ``ApplyResult``, the overlay's graph and tombstones, its adjacency
    queries and the compacted graph with its id maps are identical."""
    gj, _ = _random_graph(JaxGraph, 120, 600, 4, seed)
    gt, _ = _random_graph(Graph, 120, 600, 4, seed)
    _assert_graphs_equal(gt, gj)
    dj, dt = JaxDeltaGraph(gj), DeltaGraph(gt)
    rng_j, rng_t = np.random.default_rng(seed + 50), np.random.default_rng(seed + 50)
    for _ in range(3):
        bj = jax_churn(dj, 0.08, rng_j)
        bt = random_churn_batch(dt, 0.08, rng_t)
        _assert_dataclass_equal(bt, bj)
        _assert_dataclass_equal(dt.apply(bt), dj.apply(bj))
        _assert_graphs_equal(dt.g, dj.g)
        np.testing.assert_array_equal(dt.node_alive, dj.node_alive)
        np.testing.assert_array_equal(dt.edge_alive, dj.edge_alive)
    for u in range(0, dt.g.n_nodes, 7):
        np.testing.assert_array_equal(dt.incident_edges(u), dj.incident_edges(u))
        np.testing.assert_array_equal(
            dt.undirected_neighbors(u), dj.undirected_neighbors(u)
        )
    (gc_t, vmap_t, emap_t), (gc_j, vmap_j, emap_j) = dt.compact(), dj.compact()
    _assert_graphs_equal(gc_t, gc_j)
    np.testing.assert_array_equal(vmap_t, vmap_j)
    np.testing.assert_array_equal(emap_t, emap_j)


def test_mutation_log_and_compact_workload_match_jax():
    """Provisional vertex ids, a vertex delete's cascade, and the workload
    re-keyed onto the compacted graph."""
    gj, _ = _random_graph(JaxGraph, 60, 300, 3, 4)
    gt, _ = _random_graph(Graph, 60, 300, 3, 4)
    results = []
    for G, DG, Log in ((gj, JaxDeltaGraph, JaxMutationLog), (gt, DeltaGraph, MutationLog)):
        dg = DG(G)
        log = Log(G.n_nodes)
        v = log.add_vertex(partition=1)
        log.add_edge(v, 3)
        log.add_edge(5, v)
        log.delete_vertex(7)
        log.delete_edge(0)
        res = dg.apply(log.seal())
        results.append((v, dg, res))
    (vj, dj, rj), (vt, dt, rt) = results
    assert vt == vj == gt.n_nodes
    _assert_dataclass_equal(rt, rj)
    _assert_graphs_equal(dt.g, dj.g)
    csr = build_csr(gt.n_nodes, gt.src, gt.dst, symmetrize=True)
    pats = jax_khop(gj, csr, 8, seed=2, n_dcs=3)
    wl_j = JaxWorkload.from_patterns(pats, gj.n_items, 3)
    wl_t = Workload.from_patterns(pats, gt.n_items, 3)
    gc_j, vmap, emap = dj.compact()
    gc_t, _, _ = dt.compact()
    out_j = jax_compact_workload(wl_j, gj.n_nodes, gc_j, vmap, emap)
    out_t = compact_workload(wl_t, gt.n_nodes, gc_t, vmap, emap)
    np.testing.assert_array_equal(out_t.r_xy, out_j.r_xy)
    np.testing.assert_array_equal(out_t.w_xy, out_j.w_xy)
    for a, b in zip(out_t.patterns, out_j.patterns):
        np.testing.assert_array_equal(a.items, b.items)


# --------------------------------------------------------------- warm DHD
def _assert_heat_matches(sh_t, sh_j):
    np.testing.assert_array_equal(sh_t.cols, sh_j.cols)
    np.testing.assert_array_equal(sh_t.vals, sh_j.vals)
    np.testing.assert_array_equal(sh_t.q, sh_j.q)
    assert sh_t.alpha == sh_j.alpha
    np.testing.assert_allclose(sh_t.heat, sh_j.heat, **DHD_TOL)


def _assert_stats_match(st, sj):
    assert (st.frontier_size, st.halo_size, st.local_iters, st.global_iters) == (
        sj.frontier_size, sj.halo_size, sj.local_iters, sj.global_iters
    )
    np.testing.assert_allclose(st.residual, sj.residual, **DHD_TOL)


def _mutate(g, rng, n_del, n_add):
    """Alive edges after dropping ``n_del`` and adding ``n_add`` random
    edges, their weights, and the touched vertices."""
    w = rng.uniform(0.1, 1.0, g.n_edges).astype(np.float32)
    dead = rng.choice(g.n_edges, n_del, replace=False)
    keep = np.ones(g.n_edges, bool)
    keep[dead] = False
    ns = rng.integers(0, g.n_nodes, n_add)
    nd = (ns + 1 + rng.integers(0, g.n_nodes - 1, n_add)) % g.n_nodes
    nw = rng.uniform(0.1, 1.0, n_add).astype(np.float32)
    src2 = np.concatenate([g.src[keep], ns.astype(np.int32)])
    dst2 = np.concatenate([g.dst[keep], nd.astype(np.int32)])
    w2 = np.concatenate([w[keep], nw])
    touched = np.unique(np.concatenate([g.src[dead], g.dst[dead], ns, nd]))
    return w, (src2, dst2, w2), touched


@pytest.mark.parametrize(
    "n,m,n_mut,presolve",
    [
        (200, 900, 30, False),  # tests/test_streaming.py's warm-vs-cold case
        (600, 700, 2, True),  # a trickle on a sparse graph: frontier pre-solve
    ],
)
def test_warm_update_matches_jax(n, m, n_mut, presolve):
    reset_launch_counters()
    g, rng = _random_graph(Graph, n, m, 4, 7)
    w, (src2, dst2, w2), touched = _mutate(g, rng, n_mut, n_mut)
    q = rng.uniform(0.0, 1.0, g.n_nodes).astype(np.float32)
    sh_t, sh_j = StreamingHeat(device="cpu"), JaxStreamingHeat()
    assert sh_t.rebuild(g.n_nodes, g.src, g.dst, w, q) == sh_j.rebuild(
        g.n_nodes, g.src, g.dst, w, q
    )
    _assert_heat_matches(sh_t, sh_j)
    st = sh_t.update(g.n_nodes, src2, dst2, w2, q, touched)
    sj = sh_j.update(g.n_nodes, src2, dst2, w2, q, touched)
    _assert_stats_match(st, sj)
    assert (sj.local_iters > 0) == presolve
    _assert_heat_matches(sh_t, sh_j)
    assert all(c.n == 0 for c in launch_counters().values())


def test_warm_update_with_vertex_growth_matches_jax():
    """New vertices past the padded row count grow the ELL (the scenario
    of ``tests/test_streaming.py::test_warm_dhd_handles_vertex_growth``,
    sized so the growth crosses a 256-row pad boundary)."""
    g, rng = _random_graph(Graph, 254, 800, 3, 8)
    w = np.ones(g.n_edges, np.float32)
    q = rng.uniform(0.0, 1.0, g.n_nodes).astype(np.float32)
    sh_t, sh_j = StreamingHeat(device="cpu"), JaxStreamingHeat()
    sh_t.rebuild(g.n_nodes, g.src, g.dst, w, q)
    sh_j.rebuild(g.n_nodes, g.src, g.dst, w, q)
    n2 = g.n_nodes + 5
    ns = np.arange(g.n_nodes, n2, dtype=np.int32)
    nd = rng.integers(0, g.n_nodes, 5).astype(np.int32)
    src2 = np.concatenate([g.src, ns])
    dst2 = np.concatenate([g.dst, nd])
    w2 = np.concatenate([w, np.ones(5, np.float32)])
    q2 = np.concatenate([q, rng.uniform(0.0, 1.0, 5).astype(np.float32)])
    touched = np.concatenate([ns, nd])
    st = sh_t.update(n2, src2, dst2, w2, q2, touched=touched)
    sj = sh_j.update(n2, src2, dst2, w2, q2, touched=touched)
    assert sh_t.cols.shape == sh_j.cols.shape == (512, sh_j.cols.shape[1])
    _assert_stats_match(st, sj)
    _assert_heat_matches(sh_t, sh_j)


def test_field_carried_from_jax_takes_the_same_update():
    """A JAX-built field moved across with ``streaming_heat_from_numpy``:
    one warm update in each package lands on the same field."""
    g, rng = _random_graph(Graph, 600, 700, 4, 3)
    w, (src2, dst2, w2), touched = _mutate(g, rng, 3, 3)
    q = rng.uniform(0.0, 1.0, g.n_nodes).astype(np.float32)
    sh_j = JaxStreamingHeat(tol=1e-5, max_iters=32)
    sh_j.rebuild(g.n_nodes, g.src, g.dst, w, q)
    sh_t = streaming_heat_from_numpy(streaming_heat_arrays(sh_j), device="cpu")
    assert (sh_t.max_iters, sh_t.tol, tuple(sh_t.params)) == (32, 1e-5, tuple(sh_j.params))
    np.testing.assert_array_equal(sh_t.heat, sh_j.heat)
    q2 = q.copy()
    q2[touched] *= 2.0
    st = sh_t.update(g.n_nodes, src2, dst2, w2, q2, touched)
    sj = sh_j.update(g.n_nodes, src2, dst2, w2, q2, touched)
    _assert_stats_match(st, sj)
    _assert_heat_matches(sh_t, sh_j)
    # and the port's own state carries back out unchanged
    back = streaming_heat_arrays(sh_t)
    np.testing.assert_array_equal(back["heat"], sh_t.heat)
    assert back["n_nodes"] == g.n_nodes
