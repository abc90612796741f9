"""The port's EquiformerV2 and its Wigner-D machinery against the JAX
package, on the same seeded numpy inputs and one set of weights (the JAX
package's ``eqv2_init``, carried across by
``repro_torch.convert.gnn_params_from_numpy``).

Tolerances, all f32: the Wigner blocks, rotated irreps and real spherical
harmonics for l <= 6 within atol 1e-5; ``eqv2_forward`` with the layers
looped (the JAX package's scan), unrolled and in 8 edge chunks within atol
1e-5 of the JAX package's scan (``tests/test_models_gnn.py``'s bound
between its own paths), at that file's two specs; each gradient leaf
finite and within a relative RMS gap of 1e-5 (the RMS of the difference
over the RMS of the JAX gradient) on a graph with edges along +z and -z
and a zero-length edge (where ``arctan2`` and ``x ** 0`` meet their
singular points).  A leaf whose JAX gradient's RMS is under 1e-6 of the
largest leaf's is zero in exact arithmetic and rounding noise in both
packages (the attention logits' last bias: the segment softmax does not
move when every logit of a destination shifts alike), so its gap is taken
over the largest leaf's RMS.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import equiformer_v2 as jeq
from repro.models.gnn import wigner as jw
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.models.gnn import equiformer_v2 as teq
from repro_torch.models.gnn import wigner as tw
from repro_torch.train.optimizer import tree_paths
from repro_torch.train.trainer import value_and_grad

ATOL, GRAD_GAP, ZERO_LEAF = 1e-5, 1e-5, 1e-6
# tests/test_models_gnn.py's invariance (l_max 6) and chunked (l_max 3) specs
SPECS = {
    "lmax6": (dict(n_layers=2, channels=16, l_max=6, m_max=2, n_heads=4, n_rbf=8,
                   n_species=10), 0, 48),
    "lmax3": (dict(n_layers=2, channels=8, l_max=3, m_max=2, n_heads=2, n_rbf=8,
                   n_species=10), 1, 64),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's calls here are tiny: one intra-op thread a worker runs
    them fastest, and keeps parallel test workers from oversubscribing the
    cores (the previous count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(seed: int, e: int, n: int = 16):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.integers(0, 10, n).astype(np.int32),
        pos=rng.standard_normal((n, 3)).astype(np.float32),
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        edge_mask=np.ones((e,), bool),
    )


def _both(spec_kw: dict, batch: dict):
    jspec, tspec = jeq.EqV2Spec(**spec_kw), teq.EqV2Spec(**spec_kw)
    jp = jeq.eqv2_init(jax.random.PRNGKey(0), jspec)
    tp = gnn_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    return jspec, tspec, jp, tp, jb, tb


def _angles():
    """Random directions plus the poles and the azimuth's wrap."""
    rng = np.random.default_rng(3)
    theta = np.concatenate([rng.uniform(0.0, np.pi, 29), [0.0, np.pi, 1.0]])
    phi = np.concatenate([rng.uniform(-np.pi, np.pi, 29), [0.3, -2.0, np.pi]])
    return theta.astype(np.float32), phi.astype(np.float32)


def test_wigner_blocks_rotate_and_sh_match_jax():
    theta, phi = _angles()
    jb = jax.jit(lambda t, p: jw.wigner_d_blocks(6, t, p))(jnp.asarray(theta), jnp.asarray(phi))
    tb = tw.wigner_d_blocks(6, torch.as_tensor(theta), torch.as_tensor(phi))
    for l, (a, b) in enumerate(zip(jb, tb)):
        assert b.shape == (len(theta), 2 * l + 1, 2 * l + 1)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, err_msg=f"l={l}")
    feats = np.random.default_rng(4).standard_normal((len(theta), 49, 5)).astype(np.float32)
    for transpose in (False, True):
        want = jw.rotate_irreps(jnp.asarray(feats), jb, transpose=transpose)
        got = tw.rotate_irreps(torch.as_tensor(feats), tb, transpose=transpose)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    vec = np.random.default_rng(5).standard_normal((40, 3)).astype(np.float32)
    vec[:3] = [[0, 0, 1], [0, 0, -2], [1e-3, 0, 0]]
    for l_max in (0, 2, 6):
        np.testing.assert_allclose(tw.sh_real(l_max, torch.as_tensor(vec)).numpy(),
                                   np.asarray(jw.sh_real(l_max, jnp.asarray(vec))), atol=ATOL)
    jt, jp = jw.dir_to_angles(jnp.asarray(vec))
    tt, tp = tw.dir_to_angles(torch.as_tensor(vec))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_eqv2_forward_matches_jax(name):
    spec_kw, seed, e = SPECS[name]
    jspec, tspec, jp, tp, jb, tb = _both(spec_kw, _graph(seed, e))
    want = np.asarray(jax.jit(lambda p, b: jeq.eqv2_forward(p, b, jspec))(jp, jb))
    for kw in ({}, {"unroll_layers": True}, {"edge_chunks": 8}):
        got = teq.eqv2_forward(tp, tb, tspec, **kw).numpy()
        assert got.shape == want.shape == (16, 1)
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=str(kw))


def _rel_rms_gaps(got, want):
    """Each leaf's RMS gap over its JAX RMS, or over the largest leaf's RMS
    where its own is under ``ZERO_LEAF`` of that."""
    w = {k: np.asarray(v, np.float64) for k, v in tree_paths(want)}
    rms = {k: np.sqrt((v ** 2).mean()) for k, v in w.items()}
    top = max(rms.values())
    gaps = {}
    for k, g in tree_paths(got):
        assert torch.isfinite(g).all(), k
        d = np.sqrt(((g.numpy().astype(np.float64) - w[k]) ** 2).mean())
        gaps[k] = d / (rms[k] if rms[k] >= ZERO_LEAF * top else top)
    return gaps


@pytest.mark.parametrize("chunks", [1, 4])
def test_eqv2_gradients_match_jax_with_singular_edges(chunks):
    spec_kw, seed, e = SPECS["lmax3"]
    batch = _graph(seed, e)
    # an edge along +z, one along -z and a zero-length edge
    batch["pos"][1] = batch["pos"][0] + [0.0, 0.0, 1.5]
    batch["pos"][2] = batch["pos"][0] - [0.0, 0.0, 0.7]
    batch["edge_src"][:4] = [0, 0, 3, 5]
    batch["edge_dst"][:4] = [1, 2, 3, 0]
    jspec, tspec, jp, tp, jb, tb = _both(spec_kw, batch)
    target = np.random.default_rng(9).standard_normal((16, 1)).astype(np.float32)

    def jloss(p):
        out = jeq.eqv2_forward(p, jb, jspec, edge_chunks=chunks)
        return jnp.mean((out - target) ** 2)

    def tloss(p, b):
        out = teq.eqv2_forward(p, b, tspec, edge_chunks=chunks)
        return torch.mean((out - torch.as_tensor(target)) ** 2), {}

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    (tl, _), tg = value_and_grad(tloss)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    gaps = _rel_rms_gaps(tg, jax.tree_util.tree_map(np.asarray, jg))
    assert max(gaps.values()) <= GRAD_GAP, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    assert float(tg["layers"]["so2"]["w1_0"].abs().max()) > 0
