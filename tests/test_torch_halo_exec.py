"""The port's halo executor and partitioners against the JAX package.

``build_halo_program`` must give arrays bit-identical to the JAX package's
(same send order, receive slots and edge order) on seeded graphs, one of
them with a shard that no cut edge reaches; ``run_message_passing`` on
``mesh_devices(P, "cpu")`` (every shard the host) in both modes within
max-abs 1e-4 of the dense message passing computed in JAX
(``tests/test_halo_exec.py``'s bound and spec: the JAX package's own
executor needs fake devices in a subprocess), with the wire bytes that
``transfer_rows`` reports equal to ``exchange_stats``' per-device bytes x P;
``exchange_stats`` and the partition functions equal to the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import Graph as JGraph
from repro.data import partition as jpart
from repro.distributed import halo_exec as jhalo
from repro_torch.core.graph import Graph
from repro_torch.data import partition as tpart
from repro_torch.data.synthetic import community_graph
from repro_torch.distributed import halo_exec as thalo
from repro_torch.distributed.geo_sharding import mesh_devices

ARRAYS = ("send_idx", "send_mask", "edge_src", "edge_dst", "edge_mask")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's calls here are tiny: one intra-op thread a worker runs
    them fastest, and keeps parallel test workers from oversubscribing the
    cores (the previous count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(case: int):
    """(n, src, dst, partition, P) of seeded graph ``case``; case 2 keeps
    shard 3's vertices among themselves (no cut edge reaches it)."""
    rng = np.random.default_rng(case)
    n, m, P = [(32, 80, 4), (64, 200, 8), (120, 700, 5)][case]
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    part = rng.integers(0, P, n)
    if case == 2:
        part[:20] = 3
        part[20:][part[20:] == 3] = 0
        inside = (part[src] == 3) | (part[dst] == 3)
        src[inside] = rng.integers(0, 20, inside.sum())
        dst[inside] = rng.integers(0, 20, inside.sum())
    keep = src != dst
    return n, src[keep], dst[keep], part, P


def _programs(case: int):
    n, src, dst, part, P = _graph(case)
    jp = jhalo.build_halo_program(JGraph.from_edges(n, src, dst, partition=part), P)
    tp = thalo.build_halo_program(Graph.from_edges(n, src, dst, partition=part), P)
    return n, src, dst, part, P, jp, tp


@pytest.mark.parametrize("case", [0, 1, 2])
def test_program_equal_to_reference(case):
    n, src, dst, part, P, jp, tp = _programs(case)
    if case == 2:
        assert not ((part[src] == 3) != (part[dst] == 3)).any()
        assert not tp.send_mask[3].any() and not tp.send_mask[:, 3].any()
    assert (tp.n_shards, tp.n_max, tp.s_max, tp.e_max) == (jp.n_shards, jp.n_max, jp.s_max, jp.e_max)
    for f in ARRAYS:
        a, b = getattr(tp, f), getattr(jp, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert all(np.array_equal(a, b) for a, b in zip(tp.local_ids, jp.local_ids))
    feats = np.random.default_rng(case).standard_normal((n, 5)).astype(np.float32)
    np.testing.assert_array_equal(tp.scatter_features(feats), jp.scatter_features(feats))
    sh = tp.scatter_features(feats)
    np.testing.assert_array_equal(tp.gather_outputs(sh, n), jp.gather_outputs(sh, n))
    for d, layers in ((8, 2), (100, 3)):
        assert thalo.exchange_stats(tp, d, layers) == jhalo.exchange_stats(jp, d, layers)


def _dense(feats, w, src, dst, n, n_layers):
    """The spec: ``n_layers`` of mean-aggregated message passing over the
    global edges, in JAX."""
    x = jnp.asarray(feats)
    for _ in range(n_layers):
        msg = x[src] @ w
        agg = jax.ops.segment_sum(msg, jnp.asarray(dst), num_segments=n)
        deg = jax.ops.segment_sum(jnp.ones(len(dst)), jnp.asarray(dst), num_segments=n)
        x = x + jnp.tanh(agg / jnp.maximum(deg, 1.0)[:, None])
    return np.asarray(x)


@pytest.mark.parametrize("case", [1, 2])
@pytest.mark.parametrize("mode", ["halo", "allgather"])
def test_message_passing_matches_dense(case, mode):
    n, src, dst, part, P, jp, tp = _programs(case)
    rng = np.random.default_rng(10 + case)
    d, n_layers = 16, 3
    feats = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, d)) * 0.1).astype(np.float32)
    devices = mesh_devices(P, "cpu")
    out, wire = thalo.run_message_passing(
        tp, devices, torch.as_tensor(tp.scatter_features(feats)), torch.as_tensor(w),
        n_layers=n_layers, mode=mode)
    assert len(out) == P and all(o.shape == (tp.n_max, d) for o in out)
    got = tp.gather_outputs(torch.stack(out).numpy(), n)
    ref = _dense(feats, jnp.asarray(w), src, dst, n, n_layers)
    assert np.abs(got - ref).max() < 1e-4
    st = thalo.exchange_stats(tp, d, n_layers)
    assert wire == st[f"{mode}_bytes_per_device"] * P


def test_message_passing_refuses_unknown_mode():
    _, _, _, _, P, _, tp = _programs(0)
    with pytest.raises(ValueError, match="mode"):
        thalo.run_message_passing(tp, mesh_devices(P, "cpu"), torch.zeros(P, tp.n_max, 2),
                                  torch.eye(2), mode="psum")


@pytest.mark.parametrize("n_parts,seed", [(4, 0), (7, 3)])
def test_partitions_equal_to_reference(n_parts, seed):
    g = community_graph(600, n_communities=6, p_in=0.03, p_out=0.001, seed=seed)
    got = tpart.balanced_bfs_partition(g.n_nodes, g.src, g.dst, n_parts, seed=seed)
    want = jpart.balanced_bfs_partition(g.n_nodes, g.src, g.dst, n_parts, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.bincount(got).max() <= int(np.ceil(g.n_nodes / n_parts))
    h, jh = tpart.hash_partition(g.n_nodes, n_parts, seed), jpart.hash_partition(g.n_nodes, n_parts, seed)
    assert h.dtype == jh.dtype and np.array_equal(h, jh)
    for part in (got, h):
        assert tpart.edge_cut(part, g.src, g.dst) == jpart.edge_cut(part, g.src, g.dst)
    assert tpart.edge_cut(got, g.src, g.dst) < tpart.edge_cut(h, g.src, g.dst)
    assert tpart.edge_cut(got, g.src[:0], g.dst[:0]) == 0.0
