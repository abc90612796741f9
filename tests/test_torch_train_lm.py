"""The port's LM training loss and its gradients against the JAX package.

Both packages start from one set of f32 weights (the JAX package's
``init_params``, carried across as numpy by
``repro_torch.convert.lm_params_from_numpy(..., at_rest=torch.float32)``)
and one batch drawn with numpy.  The JAX side runs on the CPU with the
dense attention, as its own tests run it; on the CPU the port's ``_attend``
takes the same dense masked softmax, and ``ops.attention`` (the autograd
Function over the flash kernel) is held to autograd through
``attention_ref`` and to the JAX package's ``_attention_with_vjp`` (its
Pallas forward in interpret mode).

Tolerances, all f32: loss rtol 1e-5; each leaf's gradient within a
relative RMS gap of 1e-4 (the RMS of the difference over the RMS of the
JAX gradient); the attention Function's outputs and gradients within
1e-5 of autograd through the plain version (the same arithmetic in
another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.kernels import ops as jops
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.train.optimizer import tree_paths
from repro_torch.train.trainer import value_and_grad

# smoke configs: GQA + qk-norm, windowed GQA (5 local : 1 global), MLA +
# MoE with shared experts and the aux loss, MoE with padded experts; and
# qwen3-smoke with remat on both sides
VARIANTS = {
    "qwen3-smoke": ("qwen3-0.6b", {}),
    "gemma3-smoke": ("gemma3-27b", {}),
    "deepseek-smoke": ("deepseek-v2-lite-16b", {}),
    "granite-smoke": ("granite-moe-3b-a800m", {}),
    "qwen3-smoke-remat": ("qwen3-0.6b", {"remat": True}),
}
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_GAP = 1e-4
ATTN_TOL = 1e-5



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here are tiny: one intra-op thread a worker runs
    them fastest, and keeps parallel test workers from oversubscribing the
    cores (the previous count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def port_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(ttf.LMConfig)} - {"dtype"}
    return ttf.LMConfig(**{f: getattr(jcfg, f) for f in fields}, dtype=torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _gap(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    diff = np.sqrt(((got - want) ** 2).mean())
    scale = np.sqrt((want ** 2).mean())
    return diff / scale if scale > 0 else diff


@pytest.fixture(scope="module", params=list(VARIANTS))
def grads(request):
    """One ``train_loss`` value and gradient of each package on the same
    weights and batch."""
    arch, over = VARIANTS[request.param]
    jcfg = dataclasses.replace(jax_arch(arch).smoke_cfg, dtype=jnp.float32, **over)
    tcfg = port_cfg(jcfg)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu",
                              at_rest=torch.float32)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.train_loss(p, b, jcfg), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (tloss, taux), tg = value_and_grad(lambda p, b: ttf.train_loss(p, b, tcfg))(
        tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    return {"cfg": tcfg, "jax": (jloss, jaux, jg), "port": (tloss, taux, tg), "tp": tp}


def test_train_loss_matches_jax(grads):
    jloss, jaux, _ = grads["jax"]
    tloss, taux, _ = grads["port"]
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(taux["aux"]), float(jaux["aux"]), rtol=LOSS_RTOL,
                               atol=1e-7)
    if grads["cfg"].moe:
        assert float(taux["aux"]) > 0  # the aux loss is in the loss


def test_every_gradient_leaf_matches_jax(grads):
    jg = dict((k, v) for k, v in tree_paths(jax.tree_util.tree_map(np.asarray, grads["jax"][2])))
    tg = dict(tree_paths(grads["port"][2]))
    assert set(tg) == set(jg)
    gaps = {k: _gap(tg[k], jg[k]) for k in jg}
    assert all(tuple(tg[k].shape) == jg[k].shape for k in jg)
    bad = {k: g for k, g in gaps.items() if not g <= GRAD_GAP}
    assert not bad, f"relative RMS gradient gaps past {GRAD_GAP}: {bad}"


def test_attention_weights_get_gradients(grads):
    """The attention projections (and qk-norm gains) get non-zero gradients
    through attention: none is cut off by the kernel's forward."""
    tg = grads["port"][2]["layers"]["attn"]
    names = (["wq", "w_dkv", "w_krope", "w_uk", "w_uv"] if grads["cfg"].mla
             else ["wq", "wk", "wv"])
    names += [n for n in ("q_norm", "k_norm") if n in tg]
    for n in names:
        per_layer = tg[n].reshape(tg[n].shape[0], -1).abs().amax(dim=1)
        assert (per_layer > 0).all(), f"{n}: a layer without gradient {per_layer}"


def test_remat_gives_the_same_gradients():
    """``torch.utils.checkpoint`` per layer recomputes and changes nothing."""
    jcfg = dataclasses.replace(jax_arch("qwen3-0.6b").smoke_cfg, dtype=jnp.float32)
    tcfg = port_cfg(jcfg)
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu",
                              at_rest=torch.float32)
    tok = torch.as_tensor(np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, S)))
    batch = {"tokens": tok, "labels": tok}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = value_and_grad(lambda p, b: ttf.train_loss(p, b, cfg))(tp, batch)
    assert float(out[False][0][0]) == float(out[True][0][0])
    for (k, a), (_, b) in zip(tree_paths(out[False][1]), tree_paths(out[True][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_forward_hidden_and_unembed():
    """``skip_unembed`` returns the final-norm hidden states; unembedding
    them gives ``forward``'s logits, and ``hidden_forward`` returns them."""
    cfg = port_cfg(jax_arch("gemma3-27b").smoke_cfg)
    tp = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu", at_rest=torch.float32)
    tok = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)))
    logits, _, aux = ttf.forward(tp, tok, cfg)
    x, aux2 = ttf.hidden_forward(tp, tok, cfg)
    assert x.shape == (B, S, cfg.d_model)
    torch.testing.assert_close(x @ tp["embed"]["table"].T, logits, rtol=1e-6, atol=1e-6)
    assert float(aux) == float(aux2)


@pytest.mark.parametrize("n_chunks", [1, 4, 16, 6])
def test_chunked_ce_loss_matches_cross_entropy_and_jax(n_chunks):
    """The chunk loop equals ``cross_entropy`` over the full logits, and the
    JAX package's ``chunked_ce_loss``, value and gradient (6 halves to 4)."""
    rng = np.random.default_rng(n_chunks)
    x = rng.normal(size=(2, 16, 24)).astype(np.float32)
    unemb = rng.normal(size=(40, 24)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 16)).astype(np.int32)
    jval, (jgx, jgu) = jax.value_and_grad(jtf.chunked_ce_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(unemb), jnp.asarray(labels), n_chunks)
    tx, tu = (torch.tensor(a, requires_grad=True) for a in (x, unemb))
    tval = ttf.chunked_ce_loss(tx, tu, torch.as_tensor(labels), n_chunks)
    tgx, tgu = torch.autograd.grad(tval, (tx, tu))
    full = tl.cross_entropy(tx @ tu.T, torch.as_tensor(labels))
    np.testing.assert_allclose(float(tval.detach()), float(full.detach()), rtol=1e-6)
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-6)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tgu.numpy(), np.asarray(jgu), rtol=1e-5, atol=1e-7)


def test_cross_entropy_gradient_matches_jax():
    """``layers.cross_entropy`` (with and without a mask) under autograd
    against the JAX package's."""
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        jv, jgrad = jax.value_and_grad(jl.cross_entropy)(jnp.asarray(logits),
                                                         jnp.asarray(labels), jm)
        t = torch.tensor(logits, requires_grad=True)
        tv = tl.cross_entropy(t, torch.as_tensor(labels), None if m is None
                              else torch.as_tensor(m))
        (tgrad,) = torch.autograd.grad(tv, t)
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-8)


def test_moe_aux_loss_gradient_flows_through_the_router():
    """The Switch aux loss alone: its gradient reaches the router through
    the mean router probabilities, as in the JAX package (the load counts
    carry none)."""
    rng = np.random.default_rng(9)
    d, e = 16, 6
    p = {"router": rng.normal(size=(d, e)).astype(np.float32) * 0.3,
         "w_gate": rng.normal(size=(e, d, 8)).astype(np.float32) * 0.2,
         "w_up": rng.normal(size=(e, d, 8)).astype(np.float32) * 0.2,
         "w_down": rng.normal(size=(e, 8, d)).astype(np.float32) * 0.2}
    x = rng.normal(size=(2, 8, d)).astype(np.float32)

    def jaux(p_, x_):
        return jmoe.moe_forward(p_, x_, 2, 1.25, jnp.float32)[1]["aux_loss"]

    jv, (jgp, jgx) = jax.value_and_grad(jaux, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    tv = tmoe.moe_forward(tp, tx, 2, 1.25, torch.float32)[1]["aux_loss"]
    grads = torch.autograd.grad(tv, [tp["router"], tx], allow_unused=True)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    assert float(grads[0].abs().max()) > 0
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgp["router"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-7)


# (B, Hq, Hkv, S, Dqk, Dv, causal, window, v transposed): GQA, a window,
# MLA's narrower v as a strided view, no mask
ATTN_CASES = {
    "gqa": (2, 4, 2, 24, 16, 16, True, None, False),
    "window": (1, 4, 1, 33, 8, 8, True, 5, False),
    "mla-widths-strided-v": (1, 2, 2, 20, 24, 16, True, None, True),
    "full": (1, 2, 2, 9, 8, 8, False, None, False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_function_gradients_equal_autograd_through_the_plain_version(case):
    b, hq, hkv, s, dqk, dv, causal, window, v_t = ATTN_CASES[case]
    g = torch.Generator().manual_seed(len(case))
    q = torch.randn(b, hq, s, dqk, generator=g, requires_grad=True)
    k = torch.randn(b, hkv, s, dqk, generator=g, requires_grad=True)
    vbase = torch.randn(*((b, s, hkv, dv) if v_t else (b, hkv, s, dv)), generator=g,
                        requires_grad=True)
    up = torch.randn(b, hq, s, dv, generator=g)

    def grads(fn):
        v = vbase.transpose(1, 2) if v_t else vbase
        out = fn(q, k, v, causal=causal, window=window)
        return (out, *torch.autograd.grad(out, (q, k, vbase), up))

    got, want = grads(ops.attention), grads(attention_ref)
    assert got[0].grad_fn is not None
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, w, rtol=ATTN_TOL, atol=ATTN_TOL, msg=name)


def test_attention_function_matches_jax_custom_vjp():
    """The port's Function against the JAX package's ``_attention_with_vjp``
    (its Pallas forward in interpret mode, the recompute backward): output
    and the three gradients, GQA group 2, causal."""
    rng = np.random.default_rng(10)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((1, 4, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
    up = rng.normal(size=(1, 4, 64, 32)).astype(np.float32)

    def jfn(q_, k_, v_):
        return jops.attention(q_, k_, v_, causal=True, use_kernel=True)

    jout, pull = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = pull(jnp.asarray(up))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = ops.attention(tq, tk, tv, causal=True)
    tgrads = torch.autograd.grad(tout, (tq, tk, tv), torch.as_tensor(up))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=ATTN_TOL)
