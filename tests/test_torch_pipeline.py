"""The port's data pipelines and neighbour sampler against the JAX
package's copies: the same seeds give equal batches and blocks (exact), a
prefetcher keeps the step order, and ``shard_batch`` cuts along axis 0."""
import numpy as np
import pytest

from repro.core.graph import build_csr as jbuild_csr
from repro.data import pipeline as jpipe
from repro.data import sampler as jsampler
from repro.data.synthetic import make_benchmark_graph
from repro_torch.core.graph import CSR, build_csr
from repro_torch.data import pipeline as tpipe
from repro_torch.data import sampler as tsampler


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (7, 123)])
def test_token_pipeline_matches_jax(seed, step):
    args = (151_936, 4, 64)
    got = tpipe.TokenPipeline(*args, seed=seed).batch_at(step)
    _equal(got, jpipe.TokenPipeline(*args, seed=seed).batch_at(step))
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


@pytest.mark.parametrize("seed,step", [(0, 0), (4, 9)])
def test_recsys_pipeline_matches_jax(seed, step):
    args = (1 << 22, 16_384, 32, 20)
    got = tpipe.RecsysPipeline(*args, seed=seed).batch_at(step)
    _equal(got, jpipe.RecsysPipeline(*args, seed=seed).batch_at(step))
    assert got["hist_items"].shape == (32, 20) and got["label"].dtype == np.float32


def test_iterators_match_jax():
    t, j = iter(tpipe.TokenPipeline(100, 2, 4, seed=1)), iter(jpipe.TokenPipeline(100, 2, 4,
                                                                                 seed=1))
    for _ in range(3):
        _equal(next(t), next(j))


def test_prefetcher_order():
    p = tpipe.TokenPipeline(100, 2, 4)
    pf = tpipe.Prefetcher(p, start_step=10)
    s0, b0 = pf.next()
    s1, b1 = pf.next()
    pf.stop()
    assert (s0, s1) == (10, 11)
    np.testing.assert_array_equal(b0["tokens"], p.batch_at(10)["tokens"])
    np.testing.assert_array_equal(b1["tokens"], p.batch_at(11)["tokens"])


def test_shard_batch():
    b = tpipe.TokenPipeline(100, 8, 4).batch_at(0)
    s0, s3 = tpipe.shard_batch(b, 0, 4), tpipe.shard_batch(b, 3, 4)
    assert s0["tokens"].shape == (2, 4)
    np.testing.assert_array_equal(s3["tokens"], b["tokens"][6:8])
    _equal(s3, jpipe.shard_batch(b, 3, 4))


@pytest.mark.parametrize("fanouts,seed", [([3, 2], 0), ([5], 2), ([4, 3, 2], 5)])
def test_neighbor_sampler_matches_jax(fanouts, seed):
    """The same seed draws the same padded block, over the port's own CSR
    (built by the port's ``build_csr`` from the same edges)."""
    g = make_benchmark_graph("wiki", n_dcs=4)
    csr = build_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    jcsr = jbuild_csr(g.n_nodes, g.src, g.dst, symmetrize=True)
    assert isinstance(csr, CSR)
    seeds = np.arange(8) * 7
    ts, js = tsampler.NeighborSampler(csr, fanouts, seed), jsampler.NeighborSampler(
        jcsr, fanouts, seed)
    for _ in range(2):  # two draws: the generators stay in step
        got, want = ts.sample(seeds), js.sample(seeds)
        for f in ("node_ids", "node_mask", "edge_src", "edge_dst", "edge_mask", "seeds"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.n_max, got.e_max) == tsampler.block_capacity(8, fanouts)
    es, ed = got.edge_src[got.edge_mask], got.edge_dst[got.edge_mask]
    assert got.node_mask[es].all() and got.node_mask[ed].all()
