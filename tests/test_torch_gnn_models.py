"""The port's GNN segment ops, SchNet, EGNN and MeshGraphNet against the
JAX package, on the same seeded numpy inputs and one set of weights (the
JAX package's init, carried across by
``repro_torch.convert.gnn_params_from_numpy``).

Tolerances: the segment ops within atol 1e-6 (f32 sums of a few terms;
maxima exact); f32 forwards within atol 1e-5 / rtol 1e-4; MeshGraphNet's
bf16 path within a relative RMS gap of 2e-2 (ROADMAP's bf16 tolerance:
bf16 rounds at other places in XLA); one ``make_train_step`` on each arch's
smoke loss gives the same loss within rtol 1e-5 and each first moment (0.1
x the clipped gradient) within a relative RMS gap of 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jax_arch
from repro.models.gnn import common as jc
from repro.models.gnn import egnn as je
from repro.models.gnn import meshgraphnet as jm
from repro.models.gnn import schnet as js
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.configs import get_arch, make_train_step
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.models.gnn import common as tc
from repro_torch.models.gnn import egnn as te
from repro_torch.models.gnn import meshgraphnet as tm
from repro_torch.models.gnn import schnet as ts
from repro_torch.train.optimizer import adamw_init, tree_paths

TOL = dict(atol=1e-5, rtol=1e-4)
BF16_GAP, GRAD_GAP = 2e-2, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's calls here are tiny: one intra-op thread a worker runs
    them fastest, and keeps parallel test workers from oversubscribing the
    cores (the previous count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, n=24, e=64, d=8, half_masked=False):
    """``tests/test_models_gnn.py``'s graph, optionally with every other
    edge masked out."""
    rng = np.random.default_rng(seed)
    b = dict(
        x=rng.standard_normal((n, d)).astype(np.float32),
        pos=rng.standard_normal((n, 3)).astype(np.float32),
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        edge_mask=np.ones((e,), bool),
        edge_attr=rng.standard_normal((e, 4)).astype(np.float32),
    )
    if half_masked:
        b["edge_mask"] = np.arange(e) % 2 == 0
    return b


def _pair(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean()) / np.sqrt((want ** 2).mean()))


@pytest.mark.parametrize("trail", [(), (3,), (2, 5)])
def test_segment_ops_match_jax(trail):
    rng = np.random.default_rng(len(trail))
    e, n = 40, 12
    data = rng.standard_normal((e,) + trail).astype(np.float32)
    ids = rng.integers(0, n - 3, e).astype(np.int32)  # the last 3 segments empty
    mask = rng.random(e) < 0.6
    mask[ids == 2] = False  # one segment with only masked rows
    jd, td = jnp.asarray(data), torch.as_tensor(data)
    jid, tid = jnp.asarray(ids), torch.as_tensor(ids).long()
    for m in (None, mask):
        jm_ = None if m is None else jnp.asarray(m)
        tm_ = None if m is None else torch.as_tensor(m)
        for jf, tf_ in ((jc.masked_segment_sum, tc.masked_segment_sum),
                        (jc.masked_segment_mean, tc.masked_segment_mean)):
            np.testing.assert_allclose(tf_(td, tid, n, tm_).numpy(),
                                       np.asarray(jf(jd, jid, n, jm_)), atol=1e-6)
        for neg in (-1e30, -5.0):
            got = tc.masked_segment_max(td, tid, n, tm_, neg=neg).numpy()
            np.testing.assert_array_equal(got, np.asarray(jc.masked_segment_max(jd, jid, n, jm_, neg=neg)))
            assert (got[-3:] == np.float32(neg)).all()  # empty segments -> neg
    gid = rng.integers(0, 4, e).astype(np.int32)
    for mode in ("sum", "mean"):
        np.testing.assert_allclose(
            tc.graph_readout(td, torch.as_tensor(gid).long(), 4, torch.as_tensor(mask), mode).numpy(),
            np.asarray(jc.graph_readout(jd, jnp.asarray(gid), 4, jnp.asarray(mask), mode)),
            atol=1e-6)
    with pytest.raises(ValueError):
        tc.graph_readout(td, tid, n, mode="max")


@pytest.mark.parametrize("half_masked", [False, True])
def test_schnet_egnn_mgn_forward_match_jax(half_masked):
    b = _batch(half_masked=half_masked)
    jb, tb = _pair(b)
    # schnet on integer species and on soft (one-hot-like) features
    jp = js.schnet_init(jax.random.PRNGKey(0), 8, 16, 2, 16)
    tp = gnn_params_from_numpy(_np_tree(jp), "cpu")
    z = np.random.default_rng(0).integers(0, 8, 24).astype(np.int32)
    for jx, tx in ((jb["x"], tb["x"]), (jnp.asarray(z), torch.as_tensor(z))):
        np.testing.assert_allclose(
            ts.schnet_forward(tp, dict(tb, x=tx), 2, 16, 5.0).numpy(),
            np.asarray(js.schnet_forward(jp, dict(jb, x=jx), 2, 16, 5.0)), **TOL)
    jp = je.egnn_init(jax.random.PRNGKey(1), 8, 16, 3, d_edge=4)
    tp = gnn_params_from_numpy(_np_tree(jp), "cpu")
    (jh, jx), (th, tx) = je.egnn_forward(jp, jb, 3), te.egnn_forward(tp, tb, 3)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    jp = jm.mgn_init(jax.random.PRNGKey(2), 8, 4, 16, 3, 2)
    tp = gnn_params_from_numpy(_np_tree(jp), "cpu")
    assert tp["steps"]["edge"]["mlp"]["w0"].shape == (3, 48, 16)  # stacked steps
    np.testing.assert_allclose(tm.mgn_forward(tp, tb).numpy(),
                               np.asarray(jm.mgn_forward(jp, jb)), **TOL)
    got = tm.mgn_forward(tp, tb, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jm.mgn_forward(jp, jb, dtype=jnp.bfloat16).astype(jnp.float32))
    assert _rel_rms(got.float().numpy(), want) <= BF16_GAP


@pytest.mark.parametrize("arch", ["schnet", "egnn", "meshgraphnet"])
def test_train_step_gradients_match_jax(arch):
    jarch, tarch = jax_arch(arch), get_arch(arch)
    jp = jarch.smoke_params(jax.random.PRNGKey(0))
    tp = gnn_params_from_numpy(_np_tree(jp), "cpu")
    jb = jarch.smoke_batch(jax.random.PRNGKey(0))
    tb = tarch.smoke_batch(torch.Generator().manual_seed(0))
    for k, v in tb.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jb[k]))
    jstep = jbase.make_train_step(lambda p, b: (jarch.smoke_loss(p, b), {}))
    tstep = make_train_step(lambda p, b: (tarch.smoke_loss(p, b), {}))
    _, jopt, jl = jax.jit(jstep)(jp, jadamw_init(jp), jb)
    _, topt, tl = tstep(tp, adamw_init(tp), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert int(topt["step"]) == int(jopt["step"]) == 1
    want = dict(tree_paths(_np_tree(jopt["mu"])))
    for k, mu in tree_paths(topt["mu"]):
        w = np.asarray(want[k], np.float64)
        gap = np.sqrt(((mu.numpy() - w) ** 2).mean())
        rms = np.sqrt((w ** 2).mean())
        assert gap <= GRAD_GAP * rms or (rms == 0 and gap == 0), (k, gap, rms)
