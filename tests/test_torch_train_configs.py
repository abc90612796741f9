"""The arch registry's training pieces against the JAX package's
``configs/base.py``: ``make_train_step``, and each family's
``smoke_params``, ``smoke_batch`` and ``smoke_loss``.

Both packages start from the JAX package's smoke params, carried across as
numpy by ``repro_torch.convert``.  Tolerances: one ``make_train_step`` in
f32 compute gives the same loss within rtol 1e-5, the same moments within
rtol 1e-4 (plus 1e-4 of each leaf's largest magnitude, for entries near
zero), the step count exact, and the same update of each param within
1e-4 of the leaf's largest update plus two f32 spacings of the new value,
except where the first moment is under 1e-5 of the leaf's largest: there
the gradient sits near AdamW's eps and its first step g / (|g| + eps)
turns on the gradient's last bits; ``smoke_loss`` in each
package's own bf16 compute agrees within rtol 1e-2; BST's smoke batch is
drawn from the same numpy seed and equals the JAX package's exactly.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jax_arch
from repro.models.recsys import bst as jbst
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.configs import get_arch, make_train_step
from repro_torch.convert import bst_params_from_numpy, lm_params_from_numpy
from repro_torch.models.recsys.bst import bst_loss
from repro_torch.train.optimizer import OptConfig, adamw_init, tree_paths

ARCHS = ("qwen3-0.6b", "bst")
LOSS_RTOL, STATE_RTOL, BF16_RTOL = 1e-5, 1e-4, 1e-2
EPS_ZONE = 1e-5  # of a leaf's largest first moment


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here are tiny: one intra-op thread a worker runs
    them fastest, and keeps parallel test workers from oversubscribing the
    cores (the previous count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree_paths(tree)}


def _f32(arch: str):
    """Each package's arch, its smoke config in f32 compute, with the port's
    params converted from the JAX package's ``smoke_params``."""
    jarch, tarch = jax_arch(arch), get_arch(arch)
    jp = jarch.smoke_params(jax.random.PRNGKey(0))
    if tarch.family == "lm":
        jarch = copy.copy(jarch)
        jarch.smoke_cfg = dataclasses.replace(jarch.smoke_cfg, dtype=jnp.float32)
        tarch = dataclasses.replace(
            tarch, smoke_cfg=dataclasses.replace(tarch.smoke_cfg, dtype=torch.float32))
        tp = lm_params_from_numpy(_np_tree(jp), tarch.smoke_cfg, "cpu", at_rest=torch.float32)
    else:
        tp = bst_params_from_numpy(_np_tree(jp), "cpu")
    return jarch, tarch, jp, tp


def _losses(jarch, tarch):
    """Each package's loss with an empty aux, in f32 compute (an LM's
    compute dtype is its config's, BST's is passed)."""
    if tarch.family == "lm":
        return (lambda p, b: (jarch.smoke_loss(p, b), {}),
                lambda p, b: (tarch.smoke_loss(p, b), {}))

    def jloss(p, b):
        z = jbst.bst_forward(p, b, jarch.smoke_spec, jnp.float32)
        y = b["label"]
        return jnp.mean(jnp.maximum(z, 0) - z * y + jnp.log1p(jnp.exp(-jnp.abs(z)))), {}

    return jloss, lambda p, b: (bst_loss(p, b, tarch.smoke_spec, torch.float32), {})


def _batches(jarch, tarch):
    if tarch.family == "recsys":
        jb = jarch.smoke_batch(jax.random.PRNGKey(0))
        return jb, tarch.smoke_batch(torch.Generator().manual_seed(0))
    tok = np.random.default_rng(3).integers(0, tarch.smoke_cfg.vocab_size, (2, 17))
    b = {"tokens": tok[:, :-1].astype(np.int32), "labels": tok[:, 1:].astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_matches_jax(arch):
    """One step of each package's ``make_train_step`` (AdamW at the
    default ``OptConfig``, as the JAX package's ``OPT``) from the same
    params and batch."""
    jarch, tarch, jp, tp = _f32(arch)
    jloss, tloss = _losses(jarch, tarch)
    jb, tb = _batches(jarch, tarch)
    assert OptConfig() == OptConfig(**dataclasses.asdict(jbase.OPT))
    jnew, jopt, jl = jbase.make_train_step(jloss)(jp, jadamw_init(jp), jb)
    tnew, topt, tl = make_train_step(tloss)(tp, adamw_init(tp), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert int(topt["step"]) == int(jopt["step"]) == 1
    mu = _flat(_np_tree(jopt["mu"]))
    for got, want in ((topt["mu"], jopt["mu"]), (topt["nu"], jopt["nu"])):
        got, want = _flat(got), _flat(_np_tree(want))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=STATE_RTOL,
                                       atol=STATE_RTOL * float(np.abs(want[k]).max()),
                                       err_msg=k)
    got, want, start = _flat(tnew), _flat(_np_tree(jnew)), _flat(tp)
    assert set(got) == set(want) == set(start)
    for k in want:
        s0 = start[k].astype(np.float64)
        step, want_step = got[k] - s0, want[k] - s0
        assert np.abs(step).max() > 0, k  # every param leaf moved
        off = np.abs(step - want_step) > (STATE_RTOL * np.abs(want_step).max()
                                          + 2 * np.spacing(np.abs(want[k])))
        # only where the gradient is near AdamW's eps, whose first step
        # g / (|g| + eps) then turns on the gradient's last bits
        assert (np.abs(mu[k][off]) <= EPS_ZONE * np.abs(mu[k]).max()).all(), (
            k, step[off], want_step[off], mu[k][off])


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_matches_jax(arch):
    """``smoke_loss`` as each package's arch has it (bf16 compute) on the
    same params and batch."""
    jarch, tarch = jax_arch(arch), get_arch(arch)
    jp = jarch.smoke_params(jax.random.PRNGKey(1))
    tp = (lm_params_from_numpy(_np_tree(jp), tarch.smoke_cfg, "cpu", at_rest=torch.float32)
          if tarch.family == "lm" else bst_params_from_numpy(_np_tree(jp), "cpu"))
    jb, tb = _batches(jarch, tarch)
    got = tarch.smoke_loss(tp, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(jarch.smoke_loss(jp, jb)), rtol=BF16_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_params_layout_matches_jax(arch):
    """The port's own ``smoke_params`` have the JAX package's leaves and
    shapes, f32 at rest, on the requested device."""
    want = _flat(_np_tree(jax_arch(arch).smoke_params(jax.random.PRNGKey(0))))
    got = dict(tree_paths(get_arch(arch).smoke_params(torch.Generator().manual_seed(0),
                                                      "cpu")))
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert v.dtype == torch.float32 and v.device.type == "cpu", k


def test_smoke_batches():
    """BST's smoke batch equals the JAX package's (both draw from
    ``numpy.random.default_rng(0)``); the LM's is two sequences of 16 ids
    in the vocabulary, labels equal to tokens, the same for the same seed."""
    jarch, tarch = jax_arch("bst"), get_arch("bst")
    want = _np_tree(jarch.smoke_batch(jax.random.PRNGKey(0)))
    got = tarch.smoke_batch(torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    lm = get_arch("qwen3-0.6b")
    a = lm.smoke_batch(torch.Generator().manual_seed(4))
    b = lm.smoke_batch(torch.Generator().manual_seed(4))
    assert a["tokens"].shape == (2, 16) and a["labels"] is a["tokens"]
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < lm.smoke_cfg.vocab_size
    assert torch.equal(a["tokens"], b["tokens"])
    loss = lm.smoke_loss(lm.smoke_params(torch.Generator().manual_seed(0), "cpu"), a)
    assert torch.isfinite(loss)
