"""The port's GNN archs in training against the JAX package: each arch's
``smoke_loss`` on the shared smoke graph, the launcher on the CPU, and a
checkpoint of ``equiformer-v2``'s smoke state crossing between the two
packages' ``CheckpointManager`` both ways.

Both packages start from the JAX package's smoke params, carried across by
``repro_torch.convert.gnn_params_from_numpy``; the smoke batch is drawn
from the same numpy seed and equals the JAX package's exactly.  Tolerance:
each ``smoke_loss`` within rtol 1e-5 (f32).  A checkpoint's leaves cross
bit for bit, the stacked per-layer leaves under the JAX package's keys.
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.train import checkpoint as jck
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.configs import get_arch, list_archs
from repro_torch.convert import gnn_params_from_numpy, opt_state_from_numpy
from repro_torch.train.checkpoint import CheckpointManager, flatten_tree
from repro_torch.train.optimizer import adamw_init, tree_map, tree_paths

REPO = pathlib.Path(__file__).resolve().parents[1]
GNN_ARCHS = ("egnn", "equiformer-v2", "meshgraphnet", "schnet")


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


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_smoke_loss_matches_jax(arch):
    jarch, tarch = jax_arch(arch), get_arch(arch)
    assert tarch.family == jarch.family == "gnn" and arch in list_archs()
    assert tarch.depth_points() == jarch.depth_points()
    jp = jarch.smoke_params(jax.random.PRNGKey(0))
    tp = gnn_params_from_numpy(_np_tree(jp), "cpu")
    ours = tree_map(lambda t: tuple(t.shape), tarch.smoke_params(torch.Generator().manual_seed(0), "cpu"))
    assert ours == jax.tree_util.tree_map(lambda x: tuple(x.shape), jp,
                                          is_leaf=lambda x: hasattr(x, "shape"))
    jb = jarch.smoke_batch(jax.random.PRNGKey(0))
    tb = tarch.smoke_batch(torch.Generator().manual_seed(0))
    want = float(jax.jit(jarch.smoke_loss)(jp, jb))
    np.testing.assert_allclose(float(tarch.smoke_loss(tp, tb)), want, rtol=1e-5)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_train_launcher_runs_gnn_on_the_cpu(tmp_path, arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--steps", "3",
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, timeout=240, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert f"[{arch}] 3 steps" in proc.stdout and "(cpu)" in proc.stdout
    losses = proc.stdout.split("loss ")[1].split()[::2]
    assert all(np.isfinite(float(x)) for x in losses)
    assert (tmp_path / "ck" / arch / "step_00000003" / "MANIFEST.json").exists()


def _jax_eqv2_state():
    """The JAX package's equiformer-v2 smoke params and an AdamW state with
    non-zero moments and step."""
    p = jax_arch("equiformer-v2").smoke_params(jax.random.PRNGKey(4))
    opt = jadamw_init(p)
    return {"params": p, "opt": {"mu": jax.tree_util.tree_map(lambda x: x * 0.5 + 0.25, p),
                                 "nu": jax.tree_util.tree_map(lambda x: x * x, p),
                                 "step": opt["step"] + 9}}


def _port_eqv2_state():
    arch = get_arch("equiformer-v2")
    p = arch.smoke_params(torch.Generator().manual_seed(6), "cpu")
    opt = adamw_init(p)
    return {"params": p, "opt": {"mu": tree_map(lambda x: x - 0.5, p),
                                 "nu": tree_map(lambda x: x * x + 1.0, p),
                                 "step": opt["step"] + 11}}


def _assert_same_leaves(flat, want):
    assert set(flat) == set(want)
    for k in want:
        assert flat[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def test_eqv2_checkpoint_crosses_both_ways(tmp_path):
    n_layers = 2  # the smoke spec's depth (configs/equiformer_v2.py)
    # JAX package -> port
    jstate = _jax_eqv2_state()
    jck.CheckpointManager(str(tmp_path / "j"), config_hash="h", async_save=False).save(9, jstate)
    step, got = CheckpointManager(str(tmp_path / "j"), config_hash="h").restore_latest(
        _port_eqv2_state())
    assert step == 9
    want = jck.flatten_tree(jstate)
    assert want["params/layers/so2/w1_0"].shape[0] == n_layers  # stacked, reference's key
    assert got["params"]["layers"]["so2"]["w1_0"].shape[0] == n_layers
    _assert_same_leaves(flatten_tree(got), want)
    # port -> JAX package
    state = _port_eqv2_state()
    CheckpointManager(str(tmp_path / "t"), config_hash="h", async_save=False).save(11, state)
    step, jgot = jck.CheckpointManager(str(tmp_path / "t"), config_hash="h").restore_latest(
        _jax_eqv2_state())
    assert step == 11
    _assert_same_leaves(jck.flatten_tree(jgot), flatten_tree(state))
    # the restored state trains on in the port: converted params and moments
    tp = gnn_params_from_numpy(_np_tree(jgot["params"]), "cpu")
    opt = opt_state_from_numpy(_np_tree(jgot["opt"]), "cpu")
    assert {k for k, _ in tree_paths(tp)} == {k for k, _ in tree_paths(state["params"])}
    assert int(opt["step"]) == 11
