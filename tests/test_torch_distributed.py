"""The port's distributed helpers against the JAX package's, on the CPU.

Same seeded numpy inputs into both packages: int8 compression (q and
scale bit-equal, the round trip within half a step), top-k, error feedback,
the elastic mesh shapes, the failure simulator, the straggler detector and
mitigator, ``mesh_env`` and its layered graph, ``mesh_devices``, and the
halo, expert and row replica plans.  Exact unless stated.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import Graph as JGraph
from repro.core.layered_graph import build_layered_graph as j_build_layered
from repro.data.synthetic import make_benchmark_graph as j_bench_graph
from repro.distributed import compression as jcomp
from repro.distributed import fault as jfault
from repro.distributed import geo_sharding as jgeo
from repro_torch.core.graph import Graph
from repro_torch.core.layered_graph import build_layered_graph
from repro_torch.data.synthetic import make_benchmark_graph
from repro_torch.distributed import collectives, compression, fault, geo_sharding


def _t(x):
    return torch.as_tensor(np.asarray(x))


# -------------------------------------------------------------- compression
@pytest.mark.parametrize("seed,n,scale", [(0, 1000, 1.0), (1, 4096, 1e-3),
                                          (2, 77, 250.0), (3, 512, 0.0)])
def test_int8_bit_equal_to_reference(seed, n, scale):
    """q and scale bit-equal to the JAX package's (round half to even, a true
    division by the scale), the round trip within half a step.  Scale 0 is
    the all-zero tensor, where the 1e-12 floor sets the scale."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    # values on exact half steps: round-half-to-even must agree
    x[:8] = np.float32(x[:8].round(2)) if scale else 0.0
    jq, js = jcomp.compress_int8(jnp.asarray(x))
    q, s = compression.compress_int8(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    back = compression.decompress_int8(q, s).numpy()
    assert np.array_equal(back, np.asarray(jcomp.decompress_int8(jq, js)))
    assert float(np.abs(back - x).max()) <= float(s) * 0.5 + 1e-6


def test_int8_half_steps_round_to_even():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    q, _ = compression.compress_int8(_t(x))  # scale 1.0 exactly
    jq, _ = jcomp.compress_int8(jnp.asarray(x))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 4] == np.asarray(jq).tolist()


@pytest.mark.parametrize("frac", [0.4, 0.05, 1.0])
def test_topk_equal_to_reference(frac):
    rng = np.random.default_rng(4)
    for x in (np.array([0.1, -5.0, 0.2, 3.0, -0.05], np.float32),
              rng.standard_normal((16, 8)).astype(np.float32)):
        out, mask = compression.compress_topk(_t(x), frac=frac)
        jout, jmask = jcomp.compress_topk(jnp.asarray(x), frac=frac)
        assert np.array_equal(mask.numpy(), np.asarray(jmask))
        assert np.array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_error_feedback_equal_to_reference(method):
    rng = np.random.default_rng(5)
    g = (rng.standard_normal(256) * 0.1).astype(np.float32)
    res, jres = torch.zeros(256), jnp.zeros(256)
    tot = np.zeros(256, np.float32)
    for _ in range(12):
        c, res = compression.apply_error_feedback(_t(g), res, method, topk_frac=0.1)
        jc, jres = jcomp.apply_error_feedback(jnp.asarray(g), jres, method, topk_frac=0.1)
        assert np.array_equal(c.numpy(), np.asarray(jc))
        assert np.array_equal(res.numpy(), np.asarray(jres))
        tot += c.numpy()
    if method == "int8":  # the accumulated compressed signal stays unbiased
        assert float(np.abs(tot - 12 * g).max()) < float(np.abs(g).max()) * 0.1 + 1e-3
    with pytest.raises(ValueError):
        compression.apply_error_feedback(_t(g), res, "zstd")


def test_init_compression_state():
    grads = {"w": torch.ones(3, 4), "b": torch.ones(5, dtype=torch.bfloat16)}
    st = compression.init_compression_state(grads)
    assert set(st) == {"w", "b"}
    assert all(v.dtype == torch.float32 and not v.any() for v in st.values())
    assert st["w"].shape == (3, 4) and st["b"].shape == (5,)


@pytest.mark.parametrize("compress", [None, "int8"])
def test_transfer_rows_wire_bytes_and_content(compress):
    """The gathered block and its wire bytes: fp32 4 B an element, int8 1 B
    an element plus the 4-byte scale."""
    rng = np.random.default_rng(6)
    payload = rng.random((50, 8)).astype(np.float32)
    rows = np.array([3, 7, 7, 11, 49])
    block, wire = collectives.transfer_rows(_t(payload), rows, "cpu", compress=compress)
    want = payload[rows]
    if compress is None:
        assert wire == rows.size * 8 * 4
        assert np.array_equal(block.numpy(), want)
    else:
        assert wire == rows.size * 8 + 4
        jq, js = jcomp.compress_int8(jnp.asarray(want))
        assert np.array_equal(block.numpy(), np.asarray(jcomp.decompress_int8(jq, js)))
        assert float(np.abs(block.numpy() - want).max()) <= 1.0 / 254 + 1e-7
    with pytest.raises(ValueError, match="compression"):
        collectives.transfer_rows(_t(payload), rows, "cpu", compress="zstd")


# -------------------------------------------------------------------- fault
@pytest.mark.parametrize("n,multi_pod", [(256, False), (240, False), (512, True),
                                         (7, False), (96, True), (1, False)])
def test_elastic_mesh_shape_equal_to_reference(n, multi_pod):
    assert fault.elastic_mesh_shape(n, multi_pod=multi_pod) == jfault.elastic_mesh_shape(
        n, multi_pod=multi_pod)


def test_failure_simulator_equal_to_reference():
    events = [(5, 2), (9, 1), (5, 3)]
    sim, jsim = fault.FailureSimulator(events), jfault.FailureSimulator(events)
    for step in range(12):
        ev, jev = sim.check(step), jsim.check(step)
        assert (ev is None) == (jev is None)
        if ev is not None:
            assert (ev.step, ev.n_failed) == (jev.step, jev.n_failed)
        assert sim.failed_devices == jsim.failed_devices


def test_straggler_detector_and_mitigator_equal_to_reference():
    rng = np.random.default_rng(7)
    det, jdet = fault.StragglerDetector(5, alpha=0.5), jfault.StragglerDetector(5, alpha=0.5)
    mit, jmit = fault.StragglerMitigator(5), jfault.StragglerMitigator(5)
    for i in range(60):
        s = int(rng.integers(0, 5))
        t = float(rng.exponential(1.0) * (4.0 if s == 3 and i > 20 else 1.0))
        for d in (det, jdet, mit, jmit):
            d.observe(s, t)
        assert det.snapshot() == jdet.snapshot()
        assert [det.is_straggler(k) for k in range(-1, 6)] == [
            jdet.is_straggler(k) for k in range(-1, 6)]
        assert mit.plan() == jmit.plan() and mit.reassigned == jmit.reassigned
        assert det.median() == jdet.median() and det.ewma(s) == jdet.ewma(s)
    assert det.n_shards == 5


# ------------------------------------------------------------- geo_sharding
@pytest.mark.parametrize("n,spp", [(8, 4), (4, None), (6, 2)])
def test_mesh_env_and_layered_graph_equal_to_reference(n, spp):
    env, jenv = geo_sharding.mesh_env(n, spp), jgeo.mesh_env(n, spp)
    for f in ("rtt_s", "bw_Bps", "c_store", "c_read", "c_write", "c_net"):
        assert np.array_equal(getattr(env, f), getattr(jenv, f))
    assert env.names == jenv.names
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 64, 200), rng.integers(0, 64, 200)
    keep = src != dst
    part = np.arange(64) % n
    lg = build_layered_graph(Graph.from_edges(64, src[keep], dst[keep], partition=part),
                             env, thresholds_s=[1e-5])
    jlg = j_build_layered(JGraph.from_edges(64, src[keep], dst[keep], partition=part),
                          jenv, thresholds_s=[1e-5])
    assert lg.n_layers == jlg.n_layers
    assert np.array_equal(lg.comp_of_dc, jlg.comp_of_dc)
    if spp:
        assert lg.n_layers == 2
        for b in lg.layers[1]:
            assert len({d // spp for d in b.dcs}) == 1


def test_mesh_devices():
    assert geo_sharding.mesh_devices(5, "cpu") == [torch.device("cpu")] * 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            geo_sharding.mesh_devices(2)  # the card is the default


@pytest.mark.parametrize("n_shards,n_layers,budget", [(4, 15, 0.25), (3, 4, 0.05)])
def test_halo_plan_equal_to_reference(n_shards, n_layers, budget):
    g = make_benchmark_graph("wiki", n_dcs=n_shards, seed=2)
    jg = j_bench_graph("wiki", n_dcs=n_shards, seed=2)
    heat = np.random.default_rng(0).random(g.n_nodes) + 0.5
    plan = geo_sharding.plan_gnn_halo(g, n_shards, vertex_heat=heat, n_layers=n_layers,
                                      budget_frac=budget)
    jplan = jgeo.plan_gnn_halo(jg, n_shards, vertex_heat=heat, n_layers=n_layers,
                               budget_frac=budget)
    assert len(plan.halo) == len(jplan.halo)
    assert all(np.array_equal(a, b) for a, b in zip(plan.halo, jplan.halo))
    assert (plan.replicated_bytes, plan.cut_edges_before, plan.cut_edges_resolved) == (
        jplan.replicated_bytes, jplan.cut_edges_before, jplan.cut_edges_resolved)
    assert plan.cut_edges_before > 0 and 0 < plan.resolve_frac <= 1.0


def test_expert_and_row_replicas_equal_to_reference():
    rng = np.random.default_rng(8)
    for load in (np.array([0.5, 0.2, 0.1, 0.1, 0.05, 0.05, 0.0, 0.0]),
                 rng.dirichlet(np.ones(64))):
        assert np.array_equal(geo_sharding.plan_expert_replicas(load, 16),
                              jgeo.plan_expert_replicas(load, 16))
    for freq, qt in ((np.concatenate([np.zeros(990), np.full(10, 100.0)]), 0.5),
                     (rng.zipf(1.3, 5000).astype(np.float64), 0.999),
                     (np.zeros(10), 0.9)):
        assert np.array_equal(geo_sharding.plan_row_replicas(freq, qt),
                              jgeo.plan_row_replicas(freq, qt))
