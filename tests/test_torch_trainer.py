"""The port's ``Trainer`` (microbatch accumulation, error-feedback
compression, checkpoints, failure recovery) and its launchers.

The JAX package's four trainer cases (``tests/test_trainer.py``) run on the
port as they stand; then both trainers take 3 steps from one set of f32
params on the same ``TokenPipeline`` batches and must end within rtol 1e-4
of each other (each leaf also within 1e-4 of its largest magnitude, for
entries near zero), losses within rtol 1e-5.  With error-feedback
compression (int8, top-k) the same holds for params and losses, and the
residuals agree within rtol 1e-3 of each leaf's largest residual except
where a value sits on a rounding boundary of the int8 grid: there the two
packages round to neighbouring steps and the residuals differ by one
quantum (at most twice the largest residual, since int8 leaves each
residual within half a quantum), at most 2 entries a leaf.
"""
import argparse
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.fault import FailureSimulator
from repro_torch.models.transformer import LMConfig, init_params, train_loss
from repro_torch.train.optimizer import OptConfig, tree_paths
from repro_torch.train.trainer import Trainer, TrainerConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = LMConfig(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
               d_ff=64, vocab_size=128, remat=False)
RTOL = 1e-4



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here are tiny: one intra-op thread a worker runs
    them fastest, and keeps parallel test workers from oversubscribing the
    cores (the previous count is restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _trainer(tmp, steps=10, **kw):
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu", at_rest=torch.float32)
    tcfg = TrainerConfig(
        total_steps=steps, ckpt_every=4, ckpt_dir=str(tmp),
        opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=steps), **kw,
    )
    return Trainer(lambda p, b: train_loss(p, b, CFG), params, tcfg, device="cpu")


def test_loss_decreases(tmp_path):
    tr = _trainer(tmp_path, steps=12)
    m = tr.run(iter(TokenPipeline(128, 8, 16)))
    assert np.mean(m["loss"][-3:]) < np.mean(m["loss"][:3])


def test_resume_continues(tmp_path):
    tr = _trainer(tmp_path, steps=8)
    tr.run(iter(TokenPipeline(128, 8, 16)))
    tr2 = _trainer(tmp_path, steps=12)
    m2 = tr2.run(iter(TokenPipeline(128, 8, 16)))
    assert len(m2["loss"]) == 4  # resumed at 8, ran 4 more
    assert int(tr2.opt_state["step"]) == 12


def test_failure_recovery(tmp_path):
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu", at_rest=torch.float32)
    tcfg = TrainerConfig(total_steps=10, ckpt_every=3, ckpt_dir=str(tmp_path),
                         opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    tr = Trainer(lambda p, b: train_loss(p, b, CFG), params, tcfg,
                 failure_sim=FailureSimulator([(7, 1)]), device="cpu")
    m = tr.run(iter(TokenPipeline(128, 8, 16)))
    assert len(m["recoveries"]) == 1
    assert m["recoveries"][0]["restored_step"] == 6
    assert m["recoveries"][0]["new_mesh"] == ((1, 1), ("data", "model"))
    assert m["recoveries"][0]["restore_s"] >= 0


def test_microbatch_equivalence(tmp_path):
    """Accumulated microbatch grads ~= full-batch step (same data)."""
    m1 = _trainer(tmp_path / "a", steps=3, microbatch=1).run(iter(TokenPipeline(128, 8, 16)))
    m2 = _trainer(tmp_path / "b", steps=3, microbatch=2).run(iter(TokenPipeline(128, 8, 16)))
    np.testing.assert_allclose(m1["loss"], m2["loss"], rtol=2e-2)


def _flat(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree_paths(tree)}


@pytest.mark.parametrize("microbatch,compression", [(1, None), (2, None), (1, "int8"),
                                                    (2, "topk")])
def test_three_steps_match_the_jax_trainer(tmp_path, microbatch, compression):
    jcfg = jtf.LMConfig(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)
                           if f.name != "dtype"}, dtype=jnp.float32)
    tcfg = dataclasses.replace(CFG, dtype=torch.float32)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu",
                              at_rest=torch.float32)
    kw = dict(total_steps=3, ckpt_every=100, microbatch=microbatch,
              grad_compression=compression)
    jtr = JTrainer(lambda p, b: jtf.train_loss(p, b, jcfg), jp, JTrainerConfig(
        ckpt_dir=str(tmp_path / "jax"), opt=JOptConfig(lr=1e-2, warmup_steps=1,
                                                       total_steps=3), **kw))
    ttr = Trainer(lambda p, b: train_loss(p, b, tcfg), tp, TrainerConfig(
        ckpt_dir=str(tmp_path / "port"), opt=OptConfig(lr=1e-2, warmup_steps=1,
                                                       total_steps=3), **kw), device="cpu")
    jm = jtr.run(iter(TokenPipeline(128, 8, 16, seed=4)))
    tm = ttr.run(iter(TokenPipeline(128, 8, 16, seed=4)))
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    got = _flat(ttr.params)
    want = _flat(jax.tree_util.tree_map(np.asarray, jtr.params))
    assert set(got) == set(want)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=RTOL * float(np.abs(want[k]).max()), err_msg=k)
        moved += int(not np.array_equal(got[k], _flat(tp)[k]))
    assert moved == len(want)  # every leaf trained
    assert int(ttr.opt_state["step"]) == int(jtr.opt_state["step"]) == 3
    if compression:
        jres = _flat(jax.tree_util.tree_map(np.asarray, jtr.comp_state))
        assert set(ttr.comp_state) == set(jres)
        for k, want in jres.items():
            res, top = ttr.comp_state[k].numpy(), float(np.abs(want).max())
            diff = np.abs(res - want)
            off = diff > 1e-3 * top + 1e-3 * np.abs(want)
            assert off.sum() <= 2 and (diff[off] <= 2.001 * top).all(), (k, diff[off], top)


def _launch(module, *args, tmp):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, env=env, timeout=240, cwd=str(tmp))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "bst"])
def test_train_launcher_on_the_cpu(tmp_path, arch):
    proc = _launch("repro_torch.launch.train", "--arch", arch, "--steps", "2", "--device",
                   "cpu", "--ckpt-dir", str(tmp_path / "ck"), tmp=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert f"[{arch}] 2 steps" in proc.stdout and "(cpu)" in proc.stdout
    assert (tmp_path / "ck" / arch / "step_00000002" / "MANIFEST.json").exists()


def test_train_launcher_gnn_branch_waits():
    """The GNN branch no longer waits: it yields the arch's fixed smoke
    graph (numpy) every step, as the JAX package's launcher does."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train

    arch = get_arch("schnet")
    data = launch_train.make_data(arch)
    first, second = next(data), next(data)
    want = arch.smoke_batch(torch.Generator().manual_seed(0))
    assert set(first) == set(want)
    for k, v in want.items():
        assert isinstance(first[k], np.ndarray)
        np.testing.assert_array_equal(first[k], v.numpy())
        np.testing.assert_array_equal(second[k], first[k])


def _default_arch(main):
    """The ``--arch`` default of a launcher's parser, read as ``main``
    builds it (parsing is stopped before anything runs)."""
    seen = {}

    class Stop(Exception):
        pass

    def capture(self, *a, **k):
        seen["parser"] = self
        raise Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(Stop):
            main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["parser"].get_default("arch")


def test_serve_launcher_default_arch_is_the_references():
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    assert _default_arch(tserve.main) == _default_arch(jserve.main) == "qwen3-0.6b"
