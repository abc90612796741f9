"""The port's AdamW, schedule, global norm and clipping against the JAX
package's on the same seeded numpy trees, in f32: rtol 1e-6 (the same f32
arithmetic, in the same order leaf by leaf).  A tree leaf is held within
rtol 1e-6 of its largest magnitude as well (``atol = 1e-6 * max|leaf|``):
where ``b1 * mu`` and ``(1 - b1) * g`` nearly cancel, one rounding of
either term (XLA contracts a multiply-add into one FMA) is a larger share
of the small result."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.convert import opt_state_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.optimizer import tree_paths

RTOL = 1e-6


def _tree(rng, scale=1.0):
    return {"a": {"w": rng.normal(size=(5, 7)).astype(np.float32) * scale,
                  "b": rng.normal(size=(7,)).astype(np.float32) * scale},
            "z": rng.normal(size=(3, 2, 4)).astype(np.float32) * scale}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return topt.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _flat(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tree_paths(tree)}


def _close(got, want):
    got, want = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=RTOL * float(np.abs(want[k]).max()), err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 10_000, 12_000])
def test_cosine_lr(step):
    cfg = jopt.OptConfig()
    got = topt.cosine_lr(torch.tensor(step, dtype=torch.int32), topt.OptConfig())
    want = jopt.cosine_lr(jnp.asarray(step, jnp.int32), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=1e-12)


def test_global_norm():
    tree = _tree(np.random.default_rng(0))
    got = topt.global_norm(_torch(tree))
    want = jopt.global_norm(_jax(tree))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_init_layout():
    tree = _tree(np.random.default_rng(1))
    state = topt.adamw_init(_torch(tree))
    jstate = jopt.adamw_init(_jax(tree))
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    assert all(v.dtype == torch.float32 for _, v in tree_paths(state["mu"]))
    _close(state["mu"], jstate["mu"])
    _close(state["nu"], jstate["nu"])


# grad scale 1e-3: under the clip norm (no clipping); 10: clipped to norm 1
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_adamw_update_matches_jax_over_steps(grad_scale):
    """Three updates from a non-zero state (moments and step taken from a
    seeded JAX state): params, moments, step, grad norm and lr."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    cfg_j = jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    cfg_t = topt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jstate = {"mu": _jax(_tree(rng, 0.1)), "nu": jax.tree_util.tree_map(
        jnp.abs, _jax(_tree(rng, 0.01))), "step": jnp.asarray(3, jnp.int32)}
    tstate = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    jp, tp = _jax(params), _torch(params)
    for i in range(3):
        grads = _tree(rng, grad_scale)
        jp, jstate, jinfo = jopt.adamw_update(_jax(grads), jstate, jp, cfg_j)
        tp, tstate, tinfo = topt.adamw_update(_torch(grads), tstate, tp, cfg_t)
        _close(tp, jp)
        _close(tstate["mu"], jstate["mu"])
        _close(tstate["nu"], jstate["nu"])
        assert int(tstate["step"]) == int(jstate["step"]) == 4 + i
        assert tstate["step"].dtype == torch.int32
        np.testing.assert_allclose(float(tinfo["grad_norm"]), float(jinfo["grad_norm"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]), rtol=RTOL)


def test_clipping_scales_the_gradient_to_the_clip_norm():
    """With AdamW's moments at zero and one step, the first moment is
    (1 - b1) x the clipped gradient, whose norm is the clip norm."""
    rng = np.random.default_rng(3)
    params, grads = _tree(rng), _tree(rng, 50.0)
    cfg = topt.OptConfig(clip_norm=0.5)
    tp = _torch(params)
    _, state, info = topt.adamw_update(_torch(grads), topt.adamw_init(tp), tp, cfg)
    clipped = topt.global_norm(state["mu"]) / (1 - cfg.b1)
    np.testing.assert_allclose(float(clipped), 0.5, rtol=1e-5)
    assert float(info["grad_norm"]) > 0.5
    jp = _jax(params)
    _, jstate, _ = jopt.adamw_update(_jax(grads), jopt.adamw_init(jp), jp,
                                     jopt.OptConfig(clip_norm=0.5))
    _close(state["mu"], jstate["mu"])


def test_update_keeps_the_param_dtype_and_leaves_inputs_alone():
    rng = np.random.default_rng(4)
    params = _torch(_tree(rng))
    params["z"] = params["z"].to(torch.bfloat16)
    before = {k: v.clone() for k, v in tree_paths(params)}
    grads = _torch(_tree(rng))
    new, _, _ = topt.adamw_update(grads, topt.adamw_init(params), params, topt.OptConfig())
    assert new["z"].dtype == torch.bfloat16 and new["a"]["w"].dtype == torch.float32
    for k, v in tree_paths(params):
        assert torch.equal(v, before[k])
