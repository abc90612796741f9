"""The port's dense/GQA LMs (qwen3, yi, gemma3's local:global windows,
granite's padded MoE) against the JAX package on the same weights and
tokens, and the continuous-batching engine on them.

JAX params come from ``repro.models.transformer.init_params`` and cross over
as numpy (``repro_torch.convert.lm_params_from_numpy``); both sides run on
the CPU, the JAX side with its dense attention and the port with its plain
path.  Tolerances are ``tests/test_torch_models_lm.py``'s: atol/rtol 1e-4
in f32, and in bf16 2e-2 on logits and on each cache row's RMS gap over its
layer's RMS (in f32 every cache entry is also within 1e-4).  Decode runs
past ``gemma3-smoke``'s window of 8, so its local layers drop keys.

The JAX side's jitted model calls compile without XLA's excess precision
(``xla_allow_excess_precision``, on by default), so every bf16 op rounds
where the jnp program says, as the port's eager ops do.  With it on, XLA
keeps fused bf16 chains in f32: gemma3-smoke's decode caches then drift to
a row gap of 0.021 and granite-smoke's router flips a near-tie (top-2
against top-3 probabilities 1.7e-4 apart), though each side is as far from
the f32 model as the other.  With it off they read at most 0.017.

A MoE router still flips a near-tie in bf16 now and then: where its top-k
and next probabilities lie closer than bf16's rounding of the router's
input moves them, either side's choice is sound.  Both sides' routers are
recorded (the chosen experts and the margin, k-th minus (k+1)-th
probability, of every layer), and in bf16 a logit row is not compared only
where the two chose different experts in some layer.  At a row's first such
layer the two margins must sum below ``2 * ROUTER_TIE``, and at most
``MAX_FLIPPED_ROWS`` rows of a call may flip; either failing fails the test
(granite-smoke's forward: 1 row of 28 flips, in layer 1, at margins 2.7e-4
and 1.3e-3).  In f32 every row is compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_arch
from repro_torch.convert import F32_PARAMS, lm_params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serve.engine import Engine, Request, ServeConfig

GQA_ARCHS = ("qwen3-0.6b", "yi-6b", "gemma3-27b", "granite-moe-3b-a800m")
LM_ARCHS = GQA_ARCHS + ("deepseek-v2-lite-16b",)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# prefill 6 tokens, then decode positions 6-13: past gemma3-smoke's window
S_TOTAL, S_PRE = 14, 6
ROUTER_TIE = 1e-3
MAX_FLIPPED_ROWS = 2


def port_cfg(jcfg, dtype):
    fields = {f.name for f in dataclasses.fields(ttf.LMConfig)} - {"dtype"}
    return ttf.LMConfig(**{f: getattr(jcfg, f) for f in fields}, dtype=dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args``' shapes, bf16 rounded op by op."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _close_rows(got, want, tol, flipped=None):
    """Logits ``[..., V]`` within ``tol`` at every position where
    ``flipped`` (a router near-tie broken apart, bf16 MoE only) is not set."""
    got, want = _np(got), _np(want)
    if flipped is not None:
        keep = ~flipped.numpy()
        got, want = got[keep], want[keep]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


class RouterRecord:
    """Installed over the port's ``moe_forward`` (the name the decoder
    calls): records each call's chosen experts, ``[B, S, k]`` sorted, and
    its margin (k-th minus (k+1)-th probability), ``[B, S]``."""

    def __init__(self) -> None:
        self.calls = []
        self.fn = ttf.moe_forward

    def __call__(self, p, h, top_k, capacity_factor=1.25, dtype=torch.bfloat16, **kw):
        logits = h.reshape(-1, h.shape[-1]).to(dtype).float() @ p["router"]
        if kw.get("n_active") is not None:
            logits[:, kw["n_active"]:] = -1e30
        top = torch.topk(torch.softmax(logits, dim=-1), top_k + 1, dim=-1)
        chosen = top.indices[:, :top_k].sort(dim=-1).values
        margin = top.values[:, -2] - top.values[:, -1]
        self.calls.append((chosen.reshape(*h.shape[:2], top_k).numpy(),
                           margin.reshape(h.shape[:2]).numpy()))
        return self.fn(p, h, top_k, capacity_factor, dtype, **kw)

    def read(self) -> list:
        """The calls since the last read, in layer order; the record starts anew."""
        calls, self.calls = self.calls, []
        return calls

    def __enter__(self):
        ttf.moe_forward = self
        return self

    def __exit__(self, *exc) -> None:
        ttf.moe_forward = self.fn


class JaxRouterRecord(RouterRecord):
    """The same record on the JAX side, installed over the reference's
    ``moe_forward`` while its programs are traced: each compiled call
    reports its choices through an ordered ``jax.debug.callback``."""

    def __init__(self) -> None:
        self.calls = []
        self.fn = jtf.moe_forward

    def _record(self, chosen, margin) -> None:
        self.calls.append((np.asarray(chosen), np.asarray(margin)))

    def __call__(self, p, x, top_k, capacity_factor=1.25, dtype=jnp.bfloat16, n_active=None):
        logits = x.reshape(-1, x.shape[-1]).astype(dtype).astype(jnp.float32) @ p["router"]
        if n_active is not None:
            logits = jnp.where(jnp.arange(logits.shape[-1]) >= n_active, -1e30, logits)
        vals, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k + 1)
        jax.debug.callback(self._record,
                           jnp.sort(idx[:, :top_k], axis=-1).reshape(*x.shape[:2], top_k),
                           (vals[:, -2] - vals[:, -1]).reshape(x.shape[:2]), ordered=True)
        return self.fn(p, x, top_k, capacity_factor, dtype, n_active=n_active)

    def read_after(self, result) -> list:
        """``read`` once ``result`` and its callbacks are done."""
        jax.block_until_ready(result)
        jax.effects_barrier()
        return self.read()

    def __enter__(self):
        jtf.moe_forward = self
        return self

    def __exit__(self, *exc) -> None:
        jtf.moe_forward = self.fn


def _router_flips(port_calls, jax_calls) -> torch.Tensor:
    """``[B, S]``: the rows where the two routers chose different experts in
    some layer.  At a row's first such layer both sides must be near a tie
    (their margins sum below ``2 * ROUTER_TIE``), and at most
    ``MAX_FLIPPED_ROWS`` rows may flip in one call."""
    assert len(port_calls) == len(jax_calls) > 0
    flipped = np.zeros(port_calls[0][1].shape, bool)
    for layer, ((pc, pm), (jc, jm)) in enumerate(zip(port_calls, jax_calls)):
        first = (pc != jc).any(-1) & ~flipped
        sums = (pm + jm)[first]
        assert (sums < 2 * ROUTER_TIE).all(), f"layer {layer}: flips at margin sums {sums}"
        flipped |= first
    assert flipped.sum() <= MAX_FLIPPED_ROWS, f"{flipped.sum()} rows flipped"
    return torch.from_numpy(flipped)


def _pair(jcfg, dtype_name):
    jdt, tdt, _ = DTYPES[dtype_name]
    jcfg = dataclasses.replace(jcfg, dtype=jdt)
    tcfg = port_cfg(jcfg, tdt)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=[(a, d) for a in GQA_ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """Both packages on one set of weights: forward logits, prefill of the
    first S_PRE tokens (last logits, caches), then decode of the rest."""
    arch, dname = request.param
    jcfg, tcfg, jp, tp = _pair(jax_arch(arch).smoke_cfg, dname)
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, S_TOTAL))
    out = {"tol": DTYPES[dname][2], "jp": jp, "tp": tp, "tdt": tcfg.dtype, "jdt": jcfg.dtype}
    jtok = jnp.asarray(tok)
    with RouterRecord() as router, JaxRouterRecord() as jrouter:
        _run_port(out, tok, tcfg, tp, router)
        _run_jax(out, jtok, jcfg, jp, jrouter)
    return out


def _run_jax(out, jtok, jcfg, jp, jrouter):
    """The reference's side of ``run``; in a bf16 MoE, each phase's router
    flips (``_router_flips``) against the port's record."""
    moe_bf16 = jcfg.moe and jcfg.dtype == jnp.bfloat16

    def flips(port_calls, result):
        return _router_flips(port_calls, jrouter.read_after(result)) if moe_bf16 else None

    fwd = _compiled(lambda p, t: jtf.forward(p, t, jcfg)[0], jp, jtok)
    pre = _compiled(lambda p, t: jtf.prefill(p, t, jcfg), jp, jtok[:, :S_PRE])
    out["jax_forward"] = fwd(jp, jtok)
    out["flips_forward"] = flips(out["router_forward"], out["jax_forward"])
    out["jax_prefill"] = pre(jp, jtok[:, :S_PRE])
    out["flips_prefill"] = flips(out["router_prefill"], out["jax_prefill"])
    pad = S_TOTAL - S_PRE
    jc = jax.tree_util.tree_map(
        lambda v: jnp.pad(v, [(0, 0)] * (v.ndim - 2) + [(0, pad), (0, 0)]),
        out["jax_prefill"][1],
    )
    pos0 = jnp.full(2, S_PRE, jnp.int32)
    dec = _compiled(lambda p, t, c, pos: jtf.decode(p, t, c, pos, jcfg), jp, jtok[:, 0], jc, pos0)
    out["jax_decode"], out["flips_decode"] = [], []
    for port_calls, t in zip(out["router_decode"], range(S_PRE, S_TOTAL)):
        jlog, jc = dec(jp, jtok[:, t], jc, jnp.full(2, t, jnp.int32))
        out["jax_decode"].append(jlog)
        f = flips(port_calls, jlog)
        out["flips_decode"].append(None if f is None else f[:, 0])
    out["jax_caches"] = jc


def _run_port(out, tok, tcfg, tp, router):
    """The port's side of ``run``, with each phase's router record."""
    out["port_forward"] = ttf.forward(tp, torch.as_tensor(tok), tcfg)[0]
    out["router_forward"] = router.read()
    out["port_prefill"] = ttf.prefill(tp, torch.as_tensor(tok[:, :S_PRE]), tcfg)
    out["router_prefill"] = router.read()
    tc = {k: torch.nn.functional.pad(v, (0, 0, 0, S_TOTAL - S_PRE))
          for k, v in out["port_prefill"][1].items()}
    out["port_decode"], out["router_decode"] = [], []
    for t in range(S_PRE, S_TOTAL):
        pos = np.full(2, t, np.int32)
        tlog, tc = ttf.decode(tp, torch.as_tensor(tok[:, t]), tc, torch.as_tensor(pos), tcfg)
        out["port_decode"].append(tlog)
        out["router_decode"].append(router.read())
    out["port_caches"] = tc


def test_forward_logits(run):
    assert run["port_forward"].dtype == run["tdt"]
    _close_rows(run["port_forward"], run["jax_forward"], run["tol"], run["flips_forward"])


def _row_gaps(got, want) -> np.ndarray:
    """``[L, B, Hkv, S]``: the RMS gap of each cache row over its layer's RMS."""
    got, want = _np(got), _np(want)
    scale = np.sqrt((want ** 2).mean(axis=(1, 2, 3, 4)))[:, None, None, None]
    return np.sqrt(((got - want) ** 2).mean(-1)) / scale


def _close_caches(run, tc, jc):
    assert set(tc) == set(jc) == {"k", "v"}
    for key in jc:
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        gaps = _row_gaps(tc[key], jc[key]).max(axis=(1, 2, 3))
        assert (gaps <= run["tol"]).all(), f"{key}: row gap by layer {gaps}"
        if run["tdt"] == torch.float32:
            _close(tc[key], jc[key], run["tol"])


def test_prefill_logits_and_caches(run):
    (jlast, jc), (tlast, tc) = run["jax_prefill"], run["port_prefill"]
    flips = run["flips_prefill"]
    _close_rows(tlast, jlast, run["tol"], None if flips is None else flips[:, -1])
    _close_caches(run, tc, jc)


def test_decode_logits_past_the_window(run):
    for got, want, flips in zip(run["port_decode"], run["jax_decode"], run["flips_decode"]):
        _close_rows(got, want, run["tol"], flips)
    # the caches, written in place position by position
    _close_caches(run, run["port_caches"], run["jax_caches"])


def _late(c, at):
    c[:, :, at + 1] = c[:, :, at]
    c[:, :, at] = 0


def _skipped(c, at):
    c[:, :, at] = 0


def _swapped_rows(c, at):
    c[:, :, at] = c[:, :, at].flip(0)


def _other_head(c, at):
    c[:, :, at] = c[:, :, at].flip(1)


@pytest.mark.parametrize("key", ["k", "v"])
@pytest.mark.parametrize("fault", [_late, _skipped, _swapped_rows, _other_head],
                         ids=lambda f: f.__name__.strip("_"))
def test_cache_check_catches_a_wrong_write(run, fault, key):
    """The row gap fails a planted fault in the last layer's next-to-last
    decode write (one position late, skipped, into the other batch row, or
    into the other kv head)."""
    tc = {k: v.clone() for k, v in run["port_caches"].items()}
    fault(tc[key][-1], S_TOTAL - 2)
    with pytest.raises(AssertionError, match="row gap"):
        _close_caches(run, tc, run["jax_caches"])


def test_converted_weights_are_the_jax_cast(run):
    """Every matmul weight is JAX's ``.astype(cfg.dtype)`` stored once; the
    norm gains (``q_norm`` and ``k_norm`` included) and the router stay f32."""
    flat_j = jax.tree_util.tree_flatten_with_path(run["jp"])[0]
    names = set()
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        node = run["tp"]
        for k in keys:
            node = node[k]
        f32 = keys[-1] in F32_PARAMS
        assert node.dtype == (torch.float32 if f32 else run["tdt"]), keys
        want = np.asarray(leaf if f32 else leaf.astype(run["jdt"]), np.float32)
        np.testing.assert_array_equal(node.float().numpy(), want)
        names.add(keys[-1])
    assert {"wq", "wk", "wv", "wo"} <= names


def test_qk_norm_gains_convert_as_f32():
    """qwen3's per-head gains keep every f32 bit through the conversion
    (bf16 would round 1 + 2^-10 to 1)."""
    assert {"q_norm", "k_norm"} <= F32_PARAMS
    jcfg = jax_arch("qwen3-0.6b").smoke_cfg
    tree = jax.tree_util.tree_map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg))
    gain = np.full_like(tree["layers"]["attn"]["q_norm"], 1 + 2 ** -10)
    tree["layers"]["attn"]["q_norm"] = tree["layers"]["attn"]["k_norm"] = gain
    tp = lm_params_from_numpy(tree, port_cfg(jcfg, torch.bfloat16), device="cpu")
    for key in ("q_norm", "k_norm"):
        assert tp["layers"]["attn"][key].dtype == torch.float32
        np.testing.assert_array_equal(tp["layers"]["attn"][key].numpy(), gain)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("which", ["cfg", "smoke_cfg"])
def test_layer_windows_match_jax(arch, which):
    jcfg = getattr(jax_arch(arch), which)
    tcfg = getattr(get_arch(arch), which)
    got = tcfg.layer_windows()
    assert all(type(w) is int for w in got)
    assert got == [int(w) for w in np.asarray(jcfg.layer_windows())]
    assert ttf._GLOBAL_WINDOW == jtf._GLOBAL_WINDOW


@pytest.mark.parametrize("window", [1500, jtf._GLOBAL_WINDOW], ids=["window", "global"])
def test_chunked_dyn_window_matches_jax_at_4096(window):
    """The reference's path past 2,048 positions against the port's, which
    is ``_attend``'s (``chunked_attention`` with the layer's window, ``None``
    on a global layer), on one narrow head; f32."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 1, 4096, 8)).astype(np.float32) for _ in range(3))
    want = jtf._chunked_dyn_window(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window,
                                   1024, 2048, 8 ** -0.5, 1)
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    w = None if window >= ttf._GLOBAL_WINDOW else window
    _close(tattn.chunked_attention(tq, tk, tv, causal=True, window=w), want, 1e-4)
    _close(tattn._attend(tq, tk, tv, causal=True, window=w), want, 1e-4)


@pytest.mark.parametrize("chunk", [8192, 4], ids=["dense", "chunked"])
@pytest.mark.parametrize("window", [5, jtf._GLOBAL_WINDOW], ids=["window", "global"])
def test_decode_attend_matches_jax(window, chunk):
    """Decode attention over a 12-slot cache, group 3, positions 11 and 4:
    dense and over chunks of 4 slots (the path past 8,192); f32."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 6, 1, 8)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 2, 12, 8)).astype(np.float32) for _ in range(2))
    pos = np.array([11, 4], np.int32)
    want = jtf._decode_attend(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(pos), window, 3, 8 ** -0.5, chunk)
    got = ttf._decode_attend(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                             torch.from_numpy(pos), window, 3, 8 ** -0.5, chunk)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("window", [None, 3])
def test_gqa_forward_and_decode_match_jax(window, dname):
    """The single-layer entry points, qk-normed, with and without a window;
    ``gqa_decode`` writes its cache in place at each row's position."""
    jdt, tdt, tol = DTYPES[dname]
    d, hq, hkv, hd = 32, 4, 2, 8
    jp = jattn.gqa_init(jax.random.PRNGKey(4), d, hq, hkv, hd, qk_norm=True)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              port_cfg(jax_arch("qwen3-0.6b").smoke_cfg, tdt), device="cpu")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    jout, jc = jax.jit(lambda p, x: jattn.gqa_forward(p, x, jnp.arange(9), hq, hkv,
                                                       window=window, dtype=jdt))(jp, x)
    tout, tc = tattn.gqa_forward(tp, torch.from_numpy(x), torch.arange(9), hq, hkv,
                                 window=window, dtype=tdt)
    _close(tout, jout, tol)
    for key in ("k", "v"):
        _close(tc[key], jc[key], tol)
    cache = {key: np.zeros((2, hkv, 12, hd), np.float32) for key in ("k", "v")}
    for key in cache:
        cache[key][:, :, :9] = _np(jc[key])
    xt = rng.standard_normal((2, 1, d)).astype(np.float32)
    pos = np.array([9, 4], np.int32)
    jout, jnew = jax.jit(lambda p, x, c, pos: jattn.gqa_decode(
        p, x, c, pos, hq, hkv, window=window, dtype=jdt))(
        jp, xt, {k: jnp.asarray(c, jdt) for k, c in cache.items()}, pos)
    tcache = {k: torch.from_numpy(c).to(tdt) for k, c in cache.items()}
    tout, tnew = tattn.gqa_decode(tp, torch.from_numpy(xt), tcache, torch.from_numpy(pos),
                                  hq, hkv, window=window, dtype=tdt)
    _close(tout, jout, tol)
    for key in ("k", "v"):
        assert tnew[key] is tcache[key]
        _close(tnew[key], jnew[key], tol)


def _serve(engine, req_cls, vocab):
    rng = np.random.default_rng(11)
    for rid, (plen, new) in enumerate([(5, 6), (11, 4), (5, 3), (11, 7), (5, 5)]):
        engine.submit(req_cls(rid=rid, prompt=rng.integers(0, vocab, plen),
                              max_new_tokens=new))
    order, tokens = [], {}
    for _ in range(100):
        for r in engine.step():
            order.append(r.rid)
            tokens[r.rid] = list(r.out_tokens)
        if not engine.queue and all(s is None for s in engine.slots):
            break
    return order, tokens


@pytest.mark.parametrize("arch", ["gemma3-27b", "granite-moe-3b-a800m"])
def test_engine_matches_jax_engine(arch):
    """Same tokens per request and completion order as the JAX engine (f32,
    2 slots reused): each admitted prompt's k/v land along the cache's
    sequence axis, not its head axis, and gemma3's decode runs past its
    window of 8."""
    jcfg, tcfg, jp, tp = _pair(jax_arch(arch).smoke_cfg, "float32")
    jeng = JaxEngine(jp, jcfg, JaxServeConfig(n_slots=2, max_len=24))
    teng = Engine(tp, tcfg, ServeConfig(n_slots=2, max_len=24), device="cpu")
    assert teng.caches["k"].shape == (tcfg.n_layers, 2, tcfg.n_kv_heads, 24, tcfg.hd)
    want = _serve(jeng, JaxRequest, jcfg.vocab_size)
    got = _serve(teng, Request, tcfg.vocab_size)
    assert got == want
    assert len(got[0]) == 5


def test_decode_routes_to_padded_experts_as_the_reference_does(monkeypatch):
    """A fault of the reference kept for parity: ``decode`` calls
    ``moe_forward`` without ``n_active``, so a padded expert (here expert 5
    of 6, with 5 active) takes tokens at decode and never at prefill.  The
    port's logits equal the JAX package's through both."""
    base = jax_arch("granite-moe-3b-a800m").smoke_cfg
    padded = dataclasses.replace(base, n_experts=6, n_experts_active=5)
    jcfg, tcfg, jp, tp = _pair(padded, "float32")
    calls = []
    moe = ttf.moe_forward

    def recording(*args, **kw):
        out, aux = moe(*args, **kw)
        calls.append((kw.get("n_active"), aux["expert_load"].clone()))
        return out, aux

    monkeypatch.setattr(ttf, "moe_forward", recording)
    tok = np.random.default_rng(8).integers(0, jcfg.vocab_size, (4, 10))
    jlast, jc = jax.jit(lambda p, t: jtf.prefill(p, t, jcfg))(jp, tok[:, :6])
    tlast, tc = ttf.prefill(tp, torch.as_tensor(tok[:, :6]), tcfg)
    _close(tlast, jlast, 1e-4)
    prefill_calls, calls[:] = list(calls), []
    jc = jax.tree_util.tree_map(lambda v: jnp.pad(v, [(0, 0)] * 3 + [(0, 4), (0, 0)]), jc)
    tc = {k: torch.nn.functional.pad(v, (0, 0, 0, 4)) for k, v in tc.items()}
    dec = jax.jit(lambda p, t, c, pos: jtf.decode(p, t, c, pos, jcfg))
    for t in range(6, 10):
        pos = np.full(4, t, np.int32)
        jlog, jc = dec(jp, tok[:, t], jc, pos)
        tlog, tc = ttf.decode(tp, torch.as_tensor(tok[:, t]), tc, torch.as_tensor(pos), tcfg)
        _close(tlog, jlog, 1e-4)
    assert all(n == 5 and load[5] == 0 for n, load in prefill_calls)
    assert all(n is None for n, _ in calls)
    assert sum(float(load[5]) for _, load in calls) > 0
