"""The port's ``CheckpointManager`` on dict-of-tensor trees: the JAX
package's five checkpoint cases (``tests/test_checkpoint.py``), and one
on-disk layout for both packages, so a checkpoint written by either
restores in the other with equal leaves (params, f32 moments, and ``step``
as a 0-d int32)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro.configs import get_arch as jax_arch
from repro.train import checkpoint as jck
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.train.checkpoint import (
    CheckpointManager, config_hash, flatten_tree, unflatten_tree,
)
from repro_torch.train.optimizer import adamw_init, tree_map, tree_paths


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(4, 4, generator=g), "b": torch.zeros(3)},
        "opt": {"mu": {"w": torch.ones(4, 4)}, "step": torch.tensor(7, dtype=torch.int32)},
    }


def _zeros_like(state):
    return tree_map(torch.zeros_like, state)


def _equal_trees(a, b):
    pa, pb = dict(tree_paths(a)), dict(tree_paths(b))
    assert set(pa) == set(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and pa[k].shape == pb[k].shape, k
        assert torch.equal(pa[k], pb[k]), k


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = _state()
    mgr.save(10, state)
    assert mgr.latest_step() == 10
    _equal_trees(mgr.restore(10, _zeros_like(state)), state)


def test_atomicity_torn_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, _state())
    mgr.save(10, _state(1))
    # corrupt the newest manifest -> restore falls back to step 5
    with open(tmp_path / "step_00000010" / "MANIFEST.json", "w") as f:
        f.write("{not json")
    assert mgr.latest_step() == 5


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _state())
    assert mgr.all_steps() == [3, 4]


def test_config_hash_guard(tmp_path):
    mgr = CheckpointManager(str(tmp_path), config_hash="aaa", async_save=False)
    mgr.save(1, _state())
    mgr2 = CheckpointManager(str(tmp_path), config_hash="bbb")
    with pytest.raises(ValueError):
        mgr2.restore(1, _state())


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _state()
    mgr.save(3, state)
    state["params"]["w"].add_(1.0)  # the host copy was taken before save returned
    mgr.wait()
    assert mgr.latest_step() == 3
    assert not torch.equal(mgr.restore(3, _zeros_like(state))["params"]["w"],
                           state["params"]["w"])


def test_layout_keys_and_dtypes_match_jax(tmp_path):
    """Same directory names, manifest fields, leaf keys and dtypes as the
    JAX package's save of the same state, and the same config hash."""
    state = _state()
    jstate = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), state)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(2, state)
    jck.CheckpointManager(str(tmp_path / "jax"), async_save=False).save(2, jstate)
    for side in ("port", "jax"):
        assert os.listdir(tmp_path / side) == ["step_00000002"]
        assert sorted(os.listdir(tmp_path / side / "step_00000002")) == [
            "MANIFEST.json", "shard_0.npz"]
    man = {s: json.loads((tmp_path / s / "step_00000002" / "MANIFEST.json").read_text())
           for s in ("port", "jax")}
    assert set(man["port"]) == set(man["jax"])
    assert man["port"]["n_leaves"] == man["jax"]["n_leaves"] == 4
    z = {s: np.load(tmp_path / s / "step_00000002" / "shard_0.npz") for s in ("port", "jax")}
    assert sorted(z["port"].files) == sorted(z["jax"].files)
    for key in z["jax"].files:
        assert z["port"][key].dtype == z["jax"][key].dtype, key
        np.testing.assert_array_equal(z["port"][key], z["jax"][key])
    assert config_hash((1e-3, 0.9)) == jck.config_hash((1e-3, 0.9))


def _lm_state():
    """The JAX package's qwen3-smoke params and an AdamW state with non-zero
    moments and step, as JAX arrays."""
    cfg = dataclasses.replace(jax_arch("qwen3-0.6b").smoke_cfg, dtype=jnp.float32)
    p = jtf.init_params(jax.random.PRNGKey(3), cfg)
    opt = jadamw_init(p)
    opt = {"mu": jax.tree_util.tree_map(lambda x: x * 0.5 + 0.25, p),
           "nu": jax.tree_util.tree_map(lambda x: x * x, p),
           "step": opt["step"] + 17}
    return {"params": p, "opt": opt}


def _port_template(jstate):
    """A port tree of zeros shaped like ``jstate`` (f32 leaves, int32 step)."""
    def z(x):
        x = np.asarray(x)
        return torch.zeros(x.shape, dtype=torch.int32 if x.dtype == np.int32 else torch.float32)

    return tree_map(z, jax.tree_util.tree_map(np.asarray, jstate))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate = _lm_state()
    jck.CheckpointManager(str(tmp_path), config_hash="h", async_save=False).save(17, jstate)
    step, got = CheckpointManager(str(tmp_path), config_hash="h").restore_latest(
        _port_template(jstate))
    assert step == 17
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].shape == ()
    want = jck.flatten_tree(jstate)
    flat = flatten_tree(got)
    assert set(flat) == set(want)
    for k in want:
        assert flat[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jstate = _lm_state()
    state = unflatten_tree(_port_template(jstate), jck.flatten_tree(jstate))
    state["opt"]["mu"] = tree_map(lambda x: x + 1.0, state["opt"]["mu"])
    CheckpointManager(str(tmp_path), config_hash="h", async_save=False).save(18, state)
    step, got = jck.CheckpointManager(str(tmp_path), config_hash="h").restore_latest(jstate)
    assert step == 18
    want = flatten_tree(state)
    flat = jck.flatten_tree(got)
    assert set(flat) == set(want)
    for k in want:
        assert flat[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


def test_restore_puts_leaves_on_the_template_device_and_dtype(tmp_path):
    """A bf16 leaf is saved as f32 (exact) and comes back bf16; every leaf
    comes back on the template's device."""
    state = {"p": torch.randn(3, 5).to(torch.bfloat16), "opt": adamw_init({"p": torch.ones(2)})}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state)
    assert np.load(tmp_path / "step_00000001" / "shard_0.npz")["p"].dtype == np.float32
    got = mgr.restore(1, _zeros_like(state))
    assert got["p"].device == torch.device("cpu")
    _equal_trees(got, state)
