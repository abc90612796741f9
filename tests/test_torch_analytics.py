"""The offline analytics engines (paper §VII workloads): the port's tensor
versions vs the JAX package's on the CPU, on seeded graphs.

* PageRank and HITS within rtol 1e-5 / atol 1e-8 (segment sums may add in
  another order);
* SSSP and LPA exactly (minima are order-free), on graphs with an isolated
  vertex and an unreachable component;
* ``core_decomposition`` exactly;
* numpy and tensor inputs give the same result, on the device asked for.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytics as jax_analytics
from repro_torch.core import analytics

FLOAT_TOL = dict(rtol=1e-5, atol=1e-8)


def _graph(kind: str, seed: int):
    """(n, src, dst, weight): a random multigraph with self-loops, or two
    components (vertex 0's, and one it cannot reach) plus isolated
    vertices at the start, middle and end of the id range."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        n, m = 300, 2400
        src = rng.integers(0, n, m)
        dst = rng.integers(0, n, m)
    else:
        n = 241
        a = rng.integers(1, 120, (2, 900))  # component of vertex 0 (ids 0-119)
        b = rng.integers(121, 240, (2, 700))  # never reached from 0
        src = np.concatenate([[0, 0], a[0], b[0]])
        dst = np.concatenate([[5, 17], a[1], b[1]])
        keep = (src != 60) & (dst != 60)  # 60 isolated too; 120 and 240 never appear
        src, dst = src[keep], dst[keep]
    w = (rng.random(len(src)) * 3.0 + 0.01).astype(np.float32)
    return n, src.astype(np.int32), dst.astype(np.int32), w


GRAPHS = [("random", 0), ("random", 1), ("components", 2)]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n_iters", [0, 1, 15])
@pytest.mark.parametrize("kind,seed", GRAPHS)
def test_pagerank_matches_jax(kind, seed, n_iters):
    n, src, dst, _ = _graph(kind, seed)
    want = jax_analytics.pagerank(jnp.asarray(src), jnp.asarray(dst), n, n_iters)
    got = analytics.pagerank(src, dst, n, n_iters, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FLOAT_TOL)


@pytest.mark.parametrize("kind,seed", GRAPHS)
def test_hits_matches_jax(kind, seed):
    n, src, dst, _ = _graph(kind, seed)
    wh, wa = jax_analytics.hits(jnp.asarray(src), jnp.asarray(dst), n, 20)
    h, a = analytics.hits(src, dst, n, 20, device="cpu")
    np.testing.assert_allclose(_np(h), np.asarray(wh), **FLOAT_TOL)
    np.testing.assert_allclose(_np(a), np.asarray(wa), **FLOAT_TOL)


@pytest.mark.parametrize("n_iters", [1, 10, 400])
@pytest.mark.parametrize("kind,seed", GRAPHS)
def test_sssp_matches_jax_exactly(kind, seed, n_iters):
    n, src, dst, w = _graph(kind, seed)
    want = np.asarray(jax_analytics.sssp(jnp.asarray(src), jnp.asarray(dst),
                                         jnp.asarray(w), 0, n, n_iters))
    got = _np(analytics.sssp(src, dst, w, 0, n, n_iters, device="cpu"))
    np.testing.assert_array_equal(got, want)
    if kind == "components":
        assert np.isinf(got[120:]).all()  # unreachable and isolated
        assert np.isinf(got[60])
        assert np.isfinite(got[[0, 5, 17]]).all()  # the source and its out-edges


@pytest.mark.parametrize("n_iters", [1, 10, 400])
@pytest.mark.parametrize("kind,seed", GRAPHS)
def test_label_propagation_matches_jax_exactly(kind, seed, n_iters):
    n, src, dst, _ = _graph(kind, seed)
    want = np.asarray(jax_analytics.label_propagation(jnp.asarray(src), jnp.asarray(dst),
                                                      n, n_iters))
    got = analytics.label_propagation(src, dst, n, n_iters, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    if kind == "components":
        lab = _np(got)
        assert lab[60] == 60 and lab[120] == 120 and lab[240] == 240  # isolated
        if n_iters == 400:
            assert set(lab[121:240].tolist()) == {121}  # a component of its own


@pytest.mark.parametrize("kind,seed", GRAPHS)
def test_core_decomposition_matches_jax_exactly(kind, seed):
    n, src, dst, _ = _graph(kind, seed)
    core, rounds = analytics.core_decomposition(n, src, dst)
    want_core, want_rounds = jax_analytics.core_decomposition(n, src, dst)
    np.testing.assert_array_equal(core, want_core)
    assert core.dtype == want_core.dtype
    assert rounds == want_rounds


def test_tensor_inputs_and_the_device_asked_for():
    """Tensor inputs (int32 or int64) give what numpy inputs give, on the
    device asked for; without a card ``device=None`` raises, never falling
    back to the host."""
    n, src, dst, w = _graph("random", 3)
    ts, td = torch.from_numpy(src), torch.from_numpy(dst).long()
    np.testing.assert_array_equal(
        _np(analytics.pagerank(ts, td, n, device="cpu")),
        _np(analytics.pagerank(src, dst, n, device="cpu")),
    )
    got = analytics.sssp(ts, td, torch.from_numpy(w), 0, n, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), _np(analytics.sssp(src, dst, w, 0, n, device="cpu")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            analytics.label_propagation(src, dst, n, device=None)
