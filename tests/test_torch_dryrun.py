"""The port's dry run, shape cells and roofline against the JAX package's.

- ``all_cells()`` gives the reference's 40 cells: keys, kinds, skip reasons
  (4 skipped, 36 live) and flops corrections.
- Every live cell's abstract inputs have the reference's shapes, dtypes and
  specs on both production meshes.
- ``state_bytes_per_device`` equals the reference dry run's exactly for all
  72 live cell-mesh pairs, and ``model_flops`` for every cell.
- ``analyze`` gives the reference's numbers on one shared record when both
  use the same constants; the wire formulas give ``_parse_collectives``'
  bytes on the HLO of ``tests/test_launch.py`` (plus the other kinds).

The dry run itself on smoke configs: ``tests/test_torch_dryrun_smoke.py``.
"""
import os

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import all_cells as jax_cells
from repro.configs import get_arch as jax_arch
from repro.launch import roofline as jroof
from repro_torch.configs import all_cells, get_arch
from repro_torch.configs import base as tbase
from repro_torch.distributed.sharding import state_bytes_per_device
from repro_torch.launch import roofline
from repro_torch.launch.mesh import AbstractMesh

MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_state_bytes():
    """The reference dry run's ``_state_bytes_per_device``.  Importing its
    module sets ``XLA_FLAGS`` for 512 host devices; the previous value is
    put back (this process's JAX keeps its own devices)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _state_bytes_per_device
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return _state_bytes_per_device


def _live():
    return [c for c in all_cells() if not c.skip]


def test_all_cells_match_reference():
    ours = [(c.key, c.kind, c.skip, c.flops_correction) for c in all_cells()]
    ref = [(c.key, c.kind, c.skip, c.flops_correction) for c in jax_cells()]
    assert ours == ref
    assert len(ours) == 40 and sum(c[2] is not None for c in ours) == 4
    assert {c[0] for c in ours if c[2]} == {
        f"{a}/long_500k" for a in ("deepseek-v2-lite-16b", "granite-moe-3b-a800m",
                                   "qwen3-0.6b", "yi-6b")}


def _norm_spec(s):
    return tuple(tuple(a) if isinstance(a, (tuple, list)) else a for a in s)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_inputs_match_reference(mesh_name):
    shape, names = MESHES[mesh_name]
    tm, jm = AbstractMesh(shape, names), JAbstractMesh(shape, names)
    jcells = {c.key: c for c in jax_cells()}
    for cell in _live():
        (args, specs) = get_arch(cell.arch).inputs(cell, tm)
        (jargs, jspecs) = jax_arch(cell.arch).inputs(jcells[cell.key], jm)
        got = jax.tree_util.tree_flatten_with_path(
            args, is_leaf=lambda x: isinstance(x, tbase.TensorSpec))[0]
        want = jax.tree_util.tree_flatten_with_path(jargs)[0]
        assert [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for p, x in got] == [
            (jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype)) for p, x in want], cell.key
        gspec = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, tbase.P))[0]
        wspec = jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        assert [(jax.tree_util.keystr(p), _norm_spec(s)) for p, s in gspec] == [
            (jax.tree_util.keystr(p), _norm_spec(s)) for p, s in wspec], cell.key


def test_state_bytes_match_reference():
    ref_fn = _ref_state_bytes()
    states, jstates = {}, {}
    n = 0
    for cell in _live():
        arch, jarch = get_arch(cell.arch), jax_arch(cell.arch)
        key = (cell.arch, cell.shape if arch.family == "gnn" else None)
        if key not in states:
            states[key] = (arch.abstract_state_for(cell.shape) if arch.family == "gnn"
                           else arch.abstract_state())
            jstates[key] = (jarch.abstract_state_for(cell.shape) if arch.family == "gnn"
                            else jarch.abstract_state())
        for shape, names in MESHES.values():
            got = state_bytes_per_device(states[key], arch.param_partition(states[key]),
                                         AbstractMesh(shape, names))
            want = ref_fn(jstates[key], jarch.param_partition(jstates[key]),
                          JAbstractMesh(shape, names))
            assert got == want, (cell.key, names)
            n += 1
    assert n == 72


def test_model_flops_match_reference():
    for cell in all_cells():
        fam = get_arch(cell.arch).family
        assert roofline.model_flops(cell.arch, cell.shape, fam) == jroof.model_flops(
            cell.arch, cell.shape, fam), cell.key


def _record(arch="yi-6b", shape="train_4k"):
    colls = {"all-gather": {"count": 3, "tensor_bytes": 3.0e9, "wire_bytes": 2.8e9},
             "reduce-scatter": {"count": 2, "tensor_bytes": 1.0e8, "wire_bytes": 1.5e9}}
    return {
        "arch": arch, "shape": shape, "kind": "train", "mesh": "single", "ok": True,
        "mesh_shape": {"data": 16, "model": 16},
        "production": {"flops_per_device": 2.0e14, "bytes_accessed_per_device": 3.0e12,
                       "state_bytes_per_device": 5.0e9, "collectives": colls,
                       "memory": {"argument_bytes": 6 << 30, "output_bytes": 5 << 30,
                                  "temp_bytes": 9 << 30}},
        "corrected": {"flops_per_device": 2.1e14, "bytes_accessed_per_device": 3.2e12,
                      "collectives": colls},
    }


def test_analyze_matches_reference_with_shared_constants(monkeypatch):
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(roofline, "NVLINK_BW", jroof.ICI_BW)
    for arch, shape in [("yi-6b", "train_4k"), ("egnn", "molecule"), ("bst", "serve_bulk")]:
        rec = _record(arch, shape)
        assert roofline.analyze(rec) == jroof.analyze(rec)
    assert roofline.analyze({"skipped": "x"}) is None and roofline.analyze({"ok": False}) is None


HLO = """
  %ag = bf16[16,1024]{1,0} all-gather(bf16[1,1024]{1,0} %x), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
  %ar = f32[128]{0} all-reduce(f32[128]{0} %y), replica_groups=[2,16]<=[32], to_apply=%add
  %rs = f32[64,8]{1,0} reduce-scatter(f32[512,8]{1,0} %z), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %aa = bf16[32,4]{1,0} all-to-all(bf16[32,4]{1,0} %w), replica_groups={{0,1,2,3}}, dimensions={0}
  %cp = s32[10]{0} collective-permute(s32[10]{0} %v), source_target_pairs={{0,1},{1,0}}
"""


def test_wire_formulas_match_parse_collectives():
    ref = jroof._parse_collectives(HLO)
    ops = {"all-gather": (16 * 1024 * 2, 16), "all-reduce": (128 * 4, 16),
           "reduce-scatter": (64 * 8 * 4, 8), "all-to-all": (32 * 4 * 2, 4),
           "collective-permute": (10 * 4, 2)}
    assert set(ref) == set(ops)
    for kind, (nbytes, g) in ops.items():
        assert ref[kind]["tensor_bytes"] == nbytes
        assert roofline.wire_bytes(kind, float(nbytes), g) == pytest.approx(
            ref[kind]["wire_bytes"], rel=1e-12)
