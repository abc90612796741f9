"""The port's LM (layers, MLA, MoE, decoder, configs, params conversion)
against the JAX package on the same weights and tokens.

JAX params come from ``repro.models.transformer.init_params`` and cross over
as numpy (``repro_torch.convert.lm_params_from_numpy``); the JAX side runs on
the CPU with the dense attention oracle, as its own tests run it.
Tolerances: atol/rtol 1e-4 in f32 and 2e-2 in bf16 (the reference's bf16
logit tolerance, ``tests/test_models_lm.py``); MoE routing counts exact.

Caches are held row by row on every layer: the RMS gap of each (layer,
batch row, position) row over the layer's RMS stays within the tolerance,
and in f32 every entry is also within 1e-4.  In bf16, entry by entry does
not hold past layer 0: the two frameworks round bf16 at other places in the
MLA and MoE matmuls (XLA on the CPU against PyTorch), and a few cache
entries differ by up to 0.031.  Those runs read a row gap of at most 0.014,
and a row written wrongly (planted below) reads above 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import get_arch, list_archs
from repro_torch.convert import F32_PARAMS, lm_params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

ARCH = "deepseek-v2-lite-16b"
# the "mla" variant of tests/test_models_lm.py: MLA attention, dense SwiGLU
MLA_DENSE = jtf.LMConfig(name="m", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=256, mla=True, kv_lora_rank=32,
                         qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, remat=False)
VARIANTS = {"deepseek-smoke": jax_arch(ARCH).smoke_cfg, "mla": MLA_DENSE}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
S_TOTAL, S_PRE = 12, 8


def port_cfg(jcfg, dtype):
    fields = {f.name for f in dataclasses.fields(ttf.LMConfig)} - {"dtype"}
    return ttf.LMConfig(**{f: getattr(jcfg, f) for f in fields}, dtype=dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=[(v, d) for v in VARIANTS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """Both packages on one set of weights: forward logits, prefill of the
    first S_PRE tokens (last logits, caches), then decode of three more."""
    variant, dname = request.param
    jdt, tdt, tol = DTYPES[dname]
    jcfg = dataclasses.replace(VARIANTS[variant], dtype=jdt)
    tcfg = port_cfg(jcfg, tdt)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = lm_params_from_numpy(tree, tcfg, device="cpu")
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, S_TOTAL))
    out = {"tol": tol, "jp": jp, "tp": tp, "tdt": tdt, "jdt": jdt}
    fwd = jax.jit(lambda p, t: jtf.forward(p, t, jcfg)[0])
    pre = jax.jit(lambda p, t: jtf.prefill(p, t, jcfg))
    dec = jax.jit(lambda p, t, c, pos: jtf.decode(p, t, c, pos, jcfg))
    out["jax_forward"] = fwd(jp, jnp.asarray(tok))
    out["port_forward"] = ttf.forward(tp, torch.as_tensor(tok), tcfg)[0]
    out["jax_prefill"] = pre(jp, jnp.asarray(tok[:, :S_PRE]))
    out["port_prefill"] = ttf.prefill(tp, torch.as_tensor(tok[:, :S_PRE]), tcfg)
    pad = S_TOTAL - S_PRE
    jc = jax.tree_util.tree_map(
        lambda v: jnp.pad(v, [(0, 0)] * (v.ndim - 2) + [(0, pad), (0, 0)]),
        out["jax_prefill"][1],
    )
    tc = {k: torch.nn.functional.pad(v, (0, 0, 0, pad)) for k, v in out["port_prefill"][1].items()}
    out["jax_decode"], out["port_decode"] = [], []
    for t in range(S_PRE, S_PRE + 3):
        pos = np.full(2, t, np.int32)
        jlog, jc = dec(jp, jnp.asarray(tok[:, t]), jc, jnp.asarray(pos))
        tlog, tc = ttf.decode(tp, torch.as_tensor(tok[:, t]), tc, torch.as_tensor(pos), tcfg)
        out["jax_decode"].append(jlog)
        out["port_decode"].append(tlog)
    out["jax_caches"], out["port_caches"] = jc, tc
    return out


def test_forward_logits(run):
    assert run["port_forward"].dtype == run["tdt"]
    _close(run["port_forward"], run["jax_forward"], run["tol"])


def _row_gaps(got, want) -> np.ndarray:
    """``[L, B, S]``: the RMS gap of each cache row over its layer's RMS."""
    got, want = _np(got), _np(want)
    scale = np.sqrt((want ** 2).mean(axis=(1, 2, 3)))[:, None, None]
    return np.sqrt(((got - want) ** 2).mean(-1)) / scale


def _close_caches(run, tc, jc):
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        gaps = _row_gaps(tc[key], jc[key]).max(axis=(1, 2))
        assert (gaps <= run["tol"]).all(), f"{key}: row gap by layer {gaps}"
        if run["tdt"] == torch.float32:
            _close(tc[key], jc[key], run["tol"])


def test_prefill_logits_and_caches(run):
    (jlast, jc), (tlast, tc) = run["jax_prefill"], run["port_prefill"]
    _close(tlast, jlast, run["tol"])
    assert set(tc) == set(jc) == {"c_kv", "k_rope"}
    _close_caches(run, tc, jc)


def test_decode_logits(run):
    for got, want in zip(run["port_decode"], run["jax_decode"]):
        _close(got, want, run["tol"])
    # the caches, written in place position by position
    _close_caches(run, run["port_caches"], run["jax_caches"])


def _late(c, at):
    c[:, at + 1] = c[:, at]
    c[:, at] = 0


def _skipped(c, at):
    c[:, at] = 0


def _swapped_rows(c, at):
    c[:, at] = c[:, at].flip(0)


def _stale(c, at):
    c[:, at] = c[:, at - 1]


@pytest.mark.parametrize("key", ["c_kv", "k_rope"])
@pytest.mark.parametrize("fault", [_late, _skipped, _swapped_rows, _stale],
                         ids=lambda f: f.__name__.strip("_"))
def test_cache_check_catches_a_wrong_write(run, fault, key):
    """The row gap fails a planted fault in the last layer's last decode
    write (one position late, skipped, into the other batch row, or the
    previous position's value again), in bf16 as in f32."""
    tc = {k: v.clone() for k, v in run["port_caches"].items()}
    fault(tc[key][-1], S_PRE + 2)
    with pytest.raises(AssertionError, match="row gap"):
        _close_caches(run, tc, run["jax_caches"])


def test_converted_weights_are_the_jax_cast(run):
    """Every matmul weight is JAX's ``.astype(cfg.dtype)`` stored once, and
    what the reference uses in f32 (router, norm gains, kv_norm) stays f32:
    the conversion changes no number."""
    flat_j = jax.tree_util.tree_flatten_with_path(run["jp"])[0]
    n = 0
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        node = run["tp"]
        for k in keys:
            node = node[k]
        f32 = keys[-1] in F32_PARAMS
        assert node.dtype == (torch.float32 if f32 else run["tdt"]), keys
        want = np.asarray(leaf if f32 else leaf.astype(run["jdt"]), np.float32)
        np.testing.assert_array_equal(node.float().numpy(), want)
        n += 1
    assert n >= 12


@pytest.mark.parametrize("n_active", [None, 6])
def test_moe_expert_load_exact_in_f32(n_active):
    cfg = VARIANTS["deepseek-smoke"]
    jp = jmoe.moe_init(jax.random.PRNGKey(3), cfg.d_model, cfg.d_ff_expert, cfg.n_experts,
                       cfg.n_shared_experts)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              port_cfg(cfg, torch.float32), device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_forward(jp, jnp.asarray(x), cfg.top_k, dtype=jnp.float32,
                                  n_active=n_active)
    tout, taux = tmoe.moe_forward(tp, torch.from_numpy(x), cfg.top_k, dtype=torch.float32,
                                  n_active=n_active)
    np.testing.assert_array_equal(taux["expert_load"].numpy(), np.asarray(jaux["expert_load"]))
    _close(tout, jout, 1e-4)
    _close(taux["aux_loss"], jaux["aux_loss"], 1e-4)
    if n_active is not None:
        assert not taux["expert_load"][n_active:].any()


@pytest.mark.parametrize("t,want", [(1, 1), (4, 4), (24, 8), (700, 4), (64, 16), (99, 1)])
def test_moe_groups(t, want):
    assert tmoe._pick_groups(t) == want == jmoe._pick_groups(t, 16)


def _layer_cases():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    g = (rng.random(16) + 0.5).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.3
         for k, s in (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)),
                      ("w0", (16, 8)), ("b0", (8,)), ("w1", (8, 4)), ("b1", (4,)))}
    xr = rng.standard_normal((2, 3, 6, 8)).astype(np.float32)
    pos_b = np.array([[3], [11]], np.int32)
    xd = rng.standard_normal((2, 3, 1, 8)).astype(np.float32)
    labels = rng.integers(0, 16, (2, 6))
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    return {
        "rmsnorm": (lambda: tl.rmsnorm({"g": T(g)}, T(x)), lambda: jl.rmsnorm({"g": J(g)}, J(x))),
        "layernorm": (lambda: tl.layernorm({"g": T(g), "b": T(b)}, T(x)),
                      lambda: jl.layernorm({"g": J(g), "b": J(b)}, J(x))),
        "rope_seq": (lambda: tl.rope(T(xr), torch.arange(6)), lambda: jl.rope(J(xr), jnp.arange(6))),
        "rope_batch": (lambda: tl.rope(T(xd), T(pos_b)), lambda: jl.rope(J(xd), J(pos_b))),
        "dense": (lambda: tl.dense({"w": T(w["w0"])}, T(x), torch.float32),
                  lambda: jl.dense({"w": J(w["w0"])}, J(x), jnp.float32)),
        "swiglu": (lambda: tl.swiglu({k: T(w[k]) for k in ("w_gate", "w_up", "w_down")},
                                     T(x), torch.float32),
                   lambda: jl.swiglu({k: J(w[k]) for k in ("w_gate", "w_up", "w_down")},
                                     J(x), jnp.float32)),
        "mlp": (lambda: tl.mlp({k: T(w[k]) for k in ("w0", "b0", "w1", "b1")}, T(x),
                               dtype=torch.float32),
                lambda: jl.mlp({k: J(w[k]) for k in ("w0", "b0", "w1", "b1")}, J(x),
                               dtype=jnp.float32)),
        "cross_entropy": (lambda: tl.cross_entropy(T(x), T(labels)),
                          lambda: jl.cross_entropy(J(x), J(labels))),
        "cross_entropy_masked": (lambda: tl.cross_entropy(T(x), T(labels), T(mask)),
                                 lambda: jl.cross_entropy(J(x), J(labels), J(mask))),
    }


LAYER_CASES = _layer_cases()


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layers_match_jax(name):
    port, ref = LAYER_CASES[name]
    _close(port(), ref(), 1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_params_tree_matches_jax(variant):
    """Same tree, shapes and scales as the JAX package's init; dtypes at
    rest as ``lm_params_from_numpy`` stores them; one seed, one draw."""
    jcfg = VARIANTS[variant]
    tcfg = port_cfg(jcfg, torch.bfloat16)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = {}

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                tflat[path + (k,)] = v

    walk(tp)
    assert sorted(tflat) == sorted(tuple(p.key for p in path) for path, _ in jflat)
    for path, leaf in jflat:
        keys = tuple(p.key for p in path)
        t = tflat[keys]
        assert tuple(t.shape) == tuple(leaf.shape), keys
        assert t.dtype == (torch.float32 if keys[-1] in F32_PARAMS else torch.bfloat16), keys
        if leaf.size > 256 and keys[-1] not in F32_PARAMS:
            assert abs(float(t.float().std()) / float(jnp.std(leaf)) - 1.0) < 0.15, keys
    again = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["attn"]["wq"], tp["layers"]["attn"]["wq"])


LM_ARCHS = ("deepseek-v2-lite-16b", "gemma3-27b", "granite-moe-3b-a800m", "qwen3-0.6b",
            "yi-6b")
# published sizes (param_count, billions, one decimal)
LM_SIZES = {"deepseek-v2-lite-16b": 16.0, "gemma3-27b": 27.0, "granite-moe-3b-a800m": 3.9,
            "qwen3-0.6b": 0.6, "yi-6b": 5.8}


@pytest.mark.parametrize("arch", LM_ARCHS + ("bst",))
def test_configs_match_jax(arch):
    ours, theirs = get_arch(arch), jax_arch(arch)
    assert ours.family == theirs.family
    assert list_archs() == sorted(LM_ARCHS + ("bst", "egnn", "equiformer-v2", "meshgraphnet",
                                              "schnet"))
    if arch == "bst":
        assert ours.family == "recsys"
        assert (ours.spec.__dict__, ours.smoke_spec.__dict__) == (
            theirs.spec.__dict__, theirs.smoke_spec.__dict__)
        return
    assert ours.family == "lm"
    for c_ours, c_theirs in ((ours.cfg, theirs.cfg), (ours.smoke_cfg, theirs.smoke_cfg)):
        assert c_ours == port_cfg(c_theirs, torch.bfloat16)
        assert c_ours.param_count() == c_theirs.param_count()
        assert c_ours.active_param_count() == c_theirs.active_param_count()
    assert round(ours.cfg.param_count() / 1e9, 1) == LM_SIZES[arch]
