"""The port's dry run on smoke configs, on a fake ``(2, 4)`` mesh.

- A dry run of each cell below (smoke widths; LM and BST cells at small
  batch and length) writes a complete record with a non-empty collective
  census, which ``roofline.analyze`` and ``make_experiments`` read.
- For a homogeneous smoke LM, extrapolating from ``variant(1)`` and
  ``variant(2)`` gives the full depth's FLOPs and collective counts
  exactly (the claim the reference's dry run, ``repro/launch/dryrun.py``,
  rests on).
- ``LocalCounter`` counts one device's share on a fake ``(16, 16)`` mesh:
  an ``[N, K] @ [K, M]`` with N split over all 256 ranks is ``2NKM / 256``
  FLOPs and its local operands' bytes, whether DTensor propagates the
  op's sharding afresh or from its cache.
"""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, make_experiments, roofline
from repro_torch.launch.mesh import fake_world, make_cpu_mesh, make_production_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL_LM = [tbase.LMShape("train_4k", "train", 64, 8), tbase.LMShape("prefill_32k", "prefill", 64, 8),
            tbase.LMShape("decode_32k", "decode", 64, 8), tbase.LMShape("long_500k", "decode", 64, 1)]


def _smoke(name, n_layers=None):
    arch = get_arch(name)
    if arch.family != "lm":
        return arch
    cfg = arch.smoke_cfg if n_layers is None else dataclasses.replace(
        arch.smoke_cfg, n_layers=n_layers)
    return dataclasses.replace(arch, cfg=cfg)


SMOKE_CELLS = [("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "prefill_32k"),
               ("qwen3-0.6b", "decode_32k"), ("deepseek-v2-lite-16b", "train_4k"),
               ("deepseek-v2-lite-16b", "decode_32k"), ("granite-moe-3b-a800m", "train_4k"),
               ("gemma3-27b", "long_500k"), ("schnet", "molecule"), ("egnn", "full_graph_sm"),
               ("bst", "serve_p99"), ("bst", "train_batch")]


@pytest.mark.parametrize("name,shape", SMOKE_CELLS)
def test_smoke_dry_run_on_a_fake_small_mesh(monkeypatch, tmp_path, name, shape):
    monkeypatch.setattr(tbase, "LM_SHAPES", SMALL_LM)
    monkeypatch.setattr(tbase, "RECSYS_SHAPES", [
        dataclasses.replace(s, batch=64) for s in tbase.RECSYS_SHAPES])
    arch = _smoke(name, n_layers=1)
    cell = next(c for c in arch.cells() if c.shape == shape)
    with fake_world(8):
        rec = dryrun.run_cell(cell, make_cpu_mesh((2, 4)), "single", arch=arch)
    rec["ok"] = True
    p = rec["production"]
    assert p["flops_per_device"] > 0 and p["bytes_accessed_per_device"] > 0
    assert p["state_bytes_per_device"] > 0
    assert set(p["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes"}
    assert p["memory"]["argument_bytes"] > 0 and p["memory"]["temp_bytes"] > 0
    assert p["collectives"]
    for v in p["collectives"].values():
        assert v["count"] > 0 and v["wire_bytes"] >= 0
    assert rec["corrected"]["flops_per_device"] == p["flops_per_device"]
    assert roofline.analyze(rec)["dominant"] in ("compute", "memory", "collective")
    with open(dryrun.result_path("single", cell, str(tmp_path)), "w") as f:
        json.dump(rec, f)
    assert f"{cell.key} | ok" in make_experiments.render(str(tmp_path))


def test_depth_extrapolation_is_exact(monkeypatch):
    monkeypatch.setattr(tbase, "LM_SHAPES", SMALL_LM)
    full = _smoke("qwen3-0.6b", n_layers=4)
    la, lb, lfull = full.depth_points()
    assert (la, lb, lfull) == (1, 2, 4)
    cell = next(c for c in full.cells() if c.shape == "train_4k")
    with fake_world(8):
        mesh = make_cpu_mesh((2, 4))
        a, b, f = (dryrun.count_cell(x, cell, mesh)
                   for x in (full.variant(la), full.variant(lb), full))
    scale = (lfull - la) / (lb - la)
    assert a["flops_per_device"] + scale * (b["flops_per_device"] - a["flops_per_device"]) \
        == f["flops_per_device"]
    for kind in f["collectives"]:
        ca, cb = (x["collectives"].get(kind, {"count": 0})["count"] for x in (a, b))
        assert ca + scale * (cb - ca) == f["collectives"][kind]["count"], kind


def test_local_counter_counts_one_devices_share():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    n, k, m = 4096, 512, 1024
    rows = n // 256
    with fake_world(256):
        mesh = make_production_mesh()
        with FakeTensorMode(allow_non_fake_inputs=True):
            a = distribute_tensor(torch.empty(n, k), mesh, [Shard(0), Shard(0)])
            b = distribute_tensor(torch.empty(k, m), mesh, [Replicate(), Replicate()])
            b_cols = distribute_tensor(torch.empty(k, m), mesh, [Replicate(), Shard(1)])
            for _ in range(2):  # DTensor's sharding propagation afresh, then cached
                with dryrun.LocalCounter() as c:
                    a @ b
                assert c.flops == 2 * n * k * m // 256
                assert c.bytes == 4 * (rows * k + k * m + rows * m)
                assert c.collectives == {}
                with dryrun.LocalCounter() as c:
                    a + a
                assert (c.flops, c.bytes) == (0, 3 * 4 * rows * k)
            # the columns split over `model`: a's rows are all-gathered over it first
            with dryrun.LocalCounter() as c:
                a @ b_cols
    assert c.flops == 2 * (16 * rows) * k * (m // 16)
    gathered = 4 * 16 * rows * k
    assert c.collectives == {"all-gather": {
        "count": 1, "tensor_bytes": float(gathered), "wire_bytes": gathered * 15 / 16}}
