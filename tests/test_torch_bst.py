"""The port's BST (CTR scoring, user state, retrieval) against the JAX
package on ``bst``'s smoke spec, on the same weights and ids.

JAX params come from ``repro.models.recsys.bst.bst_init`` and cross over as
f32 numpy (BST keeps its params f32 at rest in both packages).
Tolerances: atol/rtol 1e-4 in f32 and 2e-2 in bf16 (the LM tests' bf16
tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models.recsys import bst as jbst
from repro_torch.configs import get_arch
from repro_torch.models.recsys import bst as tbst

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, N_CAND = 6, 50


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _batch(spec, rng):
    return {
        "hist_items": rng.integers(0, spec.n_items, (B, spec.seq_len)),
        "hist_cats": rng.integers(0, spec.n_cats, (B, spec.seq_len)),
        "target_item": rng.integers(0, spec.n_items, B),
        "target_cat": rng.integers(0, spec.n_cats, B),
    }


@pytest.fixture(scope="module")
def pair():
    spec = jax_arch("bst").smoke_spec
    jp = jbst.bst_init(jax.random.PRNGKey(0), spec)
    rng = np.random.default_rng(3)
    batch = _batch(spec, rng)
    cand = rng.integers(0, spec.n_items, (B, N_CAND))
    return spec, jp, _to_torch(jp), batch, cand


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_spec_matches_jax():
    ours, theirs = get_arch("bst"), jax_arch("bst")
    assert ours.family == theirs.family == "recsys"
    assert ours.spec == tbst.BSTSpec(**theirs.spec.__dict__)
    assert ours.smoke_spec == tbst.BSTSpec(**theirs.smoke_spec.__dict__)
    assert ours.spec.n_items == 1 << 22 and ours.spec.d_tok == 64


@pytest.mark.parametrize("dname", list(DTYPES))
def test_bst_forward_matches_jax(pair, dname):
    spec, jp, tp, batch, _ = pair
    jdt, tdt, tol = DTYPES[dname]
    want = jax.jit(lambda p, b: jbst.bst_forward(p, b, spec, jdt))(jp, batch)
    got = tbst.bst_forward(tp, {k: torch.as_tensor(v) for k, v in batch.items()}, spec, tdt)
    assert got.dtype == torch.float32 and got.shape == (B,)
    _close(got, want, tol)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_user_state_and_retrieval_match_jax(pair, dname):
    spec, jp, tp, batch, cand = pair
    jdt, tdt, tol = DTYPES[dname]

    def jax_side(p, b, c):
        user = jbst.bst_user_state(p, b, spec, jdt)
        return user, jbst.retrieval_score(p, user, c, jdt)

    juser, jscore = jax.jit(jax_side)(jp, batch, cand)
    tuser = tbst.bst_user_state(tp, {k: torch.as_tensor(v) for k, v in batch.items()}, spec,
                                tdt)
    assert tuser.dtype == tdt and tuple(tuser.shape) == (B, spec.embed_dim)
    _close(tuser, juser, tol)
    # scored from the JAX package's user state, so the check holds the
    # retrieval product alone
    tscore = tbst.retrieval_score(tp, torch.from_numpy(np.array(juser, np.float32)).to(tdt),
                                  torch.as_tensor(cand), tdt)
    assert tscore.dtype == torch.float32 and tuple(tscore.shape) == (B, N_CAND)
    _close(tscore, jscore, tol)


def test_init_tree_and_scales_match_jax():
    """Same tree, shapes and scales as the JAX package's init, all f32."""
    spec = jax_arch("bst").smoke_spec
    jp = jbst.bst_init(jax.random.PRNGKey(0), spec)
    tp = tbst.bst_init(torch.Generator().manual_seed(0), spec, device="cpu")
    jflat = {tuple(p.key for p in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {}

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                tflat[path + (k,)] = v

    walk(tp)
    assert sorted(tflat) == sorted(jflat)
    for keys, leaf in jflat.items():
        t = tflat[keys]
        assert tuple(t.shape) == tuple(leaf.shape) and t.dtype == torch.float32, keys
        if leaf.size > 256 and float(jnp.std(leaf)) > 0:
            assert abs(float(t.std()) / float(jnp.std(leaf)) - 1.0) < 0.15, keys
