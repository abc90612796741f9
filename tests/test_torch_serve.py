"""The port's continuous-batching engine against the JAX package's on the
same weights and requests (``deepseek-v2-lite-16b``'s smoke config, f32):
identical tokens per request, identical completion order, identical slot
occupancy step by step (so slots are reused the same way).  Greedy tokens
are compared in f32 only: in bf16 the two frameworks round at other places
(``tests/test_torch_models_lm.py``) and a near-tie could flip.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtf
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.cuda_lib import launch_counters, reset_launch_counters
from repro_torch.serve.engine import Engine, Request, ServeConfig

ARCH = "deepseek-v2-lite-16b"
N_SLOTS, MAX_LEN = 2, 32
# (prompt length, max_new_tokens): two prompt lengths keep the JAX side's
# prefill compiles to two; five requests on two slots reuse both slots
REQUESTS = [(5, 4), (9, 2), (5, 6), (9, 3), (5, 5)]


def _drive(engine, req_cls, vocab):
    rng = np.random.default_rng(11)
    for rid, (plen, new) in enumerate(REQUESTS):
        engine.submit(req_cls(rid=rid, prompt=rng.integers(0, vocab, plen),
                              max_new_tokens=new))
    steps = []  # per step: rids finished, then the rid held by each slot
    tokens = {}
    for _ in range(100):
        done = engine.step()
        steps.append(([r.rid for r in done],
                      [None if s is None else s.rid for s in engine.slots]))
        tokens.update({r.rid: list(r.out_tokens) for r in done})
        if not engine.queue and all(s is None for s in engine.slots):
            break
    return steps, tokens


@pytest.fixture(scope="module")
def runs():
    jcfg = dataclasses.replace(jax_arch(ARCH).smoke_cfg, dtype=jnp.float32)
    tcfg = dataclasses.replace(get_arch(ARCH).smoke_cfg, dtype=torch.float32)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    jeng = JaxEngine(jp, jcfg, JaxServeConfig(n_slots=N_SLOTS, max_len=MAX_LEN))
    teng = Engine(tp, tcfg, ServeConfig(n_slots=N_SLOTS, max_len=MAX_LEN), device="cpu")
    reset_launch_counters()
    out = {}
    out["jax"], out["jax_tokens"] = _drive(jeng, JaxRequest, jcfg.vocab_size)
    out["port"], out["port_tokens"] = _drive(teng, Request, tcfg.vocab_size)
    out["launches"] = {k: c.n for k, c in launch_counters().items()}
    return out


def _finished(steps):
    return [rid for done, _ in steps for rid in done]


def test_same_completion_order(runs):
    assert _finished(runs["port"]) == _finished(runs["jax"])
    assert sorted(_finished(runs["port"])) == list(range(len(REQUESTS)))


def test_same_slot_occupancy_and_reuse(runs):
    assert [occ for _, occ in runs["port"]] == [occ for _, occ in runs["jax"]]
    held = {}
    for _, occ in runs["port"]:
        for slot, rid in enumerate(occ):
            if rid is not None:
                held.setdefault(slot, set()).add(rid)
    assert all(len(rids) >= 2 for rids in held.values()) and len(held) == N_SLOTS


def test_same_tokens_per_request(runs):
    assert runs["port_tokens"] == runs["jax_tokens"]
    assert [len(runs["port_tokens"][rid]) for rid in range(len(REQUESTS))] == [
        n for _, n in REQUESTS
    ]


def test_cpu_engine_launches_no_kernel(runs):
    assert runs["launches"]["flash_attention"] == 0


def test_engine_refuses_params_on_another_device():
    tcfg = dataclasses.replace(get_arch(ARCH).smoke_cfg, dtype=torch.float32)
    from repro_torch.models import transformer as ttf

    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(tp, tcfg, ServeConfig(n_slots=1, max_len=8), device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(9), max_new_tokens=1))
    with pytest.raises(ValueError, match="max_len"):
        eng.step()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(tp, tcfg, ServeConfig(), device=None)


def test_launch_serve_runs_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu", "--requests", "3",
                                      "--slots", "2", "--max-new", "3"])
    serve.main()
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out


def test_launch_serve_runs_a_gqa_arch_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen3-0.6b", "--device", "cpu",
                                      "--requests", "3", "--slots", "2", "--max-new", "3"])
    serve.main()
    assert "[qwen3-0.6b] served 3 requests, 9 tokens" in capsys.readouterr().out


def test_launch_serve_offers_only_lm_archs(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "bst", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main()
