"""One gloo rank of the port's multi-rank value tests
(``tests/test_torch_mesh_values*.py``), and the helpers that spawn the
ranks and hold their results.

Each rank builds a ``("data", "model")`` mesh over the whole world and
runs the named cases: at smoke widths in f32 (one layer for training),
the same seeded params and inputs go once through the plain step on
plain tensors and once through the sharded step on DTensors laid out by
the configs' own specs (``param_partition``, ``inputs``, ``_cache_spec``),
both under ``use_mesh`` (so MoE picks the same dispatch groups).  A case
records, for each leaf (loss, gradients, logits, updated caches), the
largest absolute difference and the plain value's largest magnitude.
``check`` holds each leaf within ``RTOL`` of its own largest magnitude
plus ``ATOL`` of the case's largest (a gradient that should be zero is
held to the case's scale).

Usage: python tests/_torch_mesh_rank.py RANK WORLD ROWSxCOLS CASE,CASE STORE OUT
"""
import json
import os
import subprocess
import sys

RTOL, ATOL = 1e-5, 1e-6


def spawn(tmp, mesh_shape, cases):
    """Run ``cases`` on a ``mesh_shape`` mesh of gloo ranks (rendezvous
    through a ``FileStore`` in ``tmp``); returns each rank's results."""
    world = mesh_shape[0] * mesh_shape[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), "x".join(map(str, mesh_shape)),
         ",".join(cases), str(tmp / "store"), str(tmp / f"rank{r}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    for p in ranks:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]


def check(results, case):
    for r, got in enumerate(results):
        leaves = got[case]
        scale = max(big for _, big in leaves.values())
        assert scale > 0, (r, case)
        for name, (err, big) in leaves.items():
            assert err <= RTOL * big + ATOL * scale, (r, case, name, err, big)


def _rank_main(rank: int, world: int, mesh_shape, cases_run, store: str,
               out_path: str) -> None:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import Cell
    from repro_torch.distributed.collectives import all_reduce_region
    from repro_torch.distributed.constraints import use_mesh
    from repro_torch.distributed.sharding import P, distribute_tree, dp_axes
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import tree_paths
    from repro_torch.train.trainer import value_and_grad

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def gaps(plain, sharded):
        """{leaf: (max abs difference, max abs of the plain value)}."""
        got = dict(tree_paths(sharded))
        out = {}
        for k, want in tree_paths(plain):
            want, have = want.detach().float(), whole(got[k]).detach().float()
            assert have.shape == want.shape, (k, have.shape, want.shape)
            out[k] = (float((have - want).abs().max()), float(want.abs().max()))
        return out

    def f32_lm(name, **kw):
        arch = get_arch(name)
        return dataclasses.replace(arch, cfg=dataclasses.replace(arch.smoke_cfg,
                                                                 dtype=torch.float32, **kw))

    def lm_train(mesh, name):
        arch = f32_lm(name, n_layers=1)
        cfg = arch.cfg
        params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                at_rest=torch.float32)
        tok = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 16)),
                              dtype=torch.int32)
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
        step = value_and_grad(lambda p, b: tf.train_loss(p, b, cfg))
        pspec, _ = arch.param_partition((params, None))
        (_,), (bspec,) = arch.inputs(Cell(name, "train_4k", "train"), mesh)
        with use_mesh(mesh):
            (loss0, _), g0 = step(params, batch)
            (loss1, _), g1 = step(distribute_tree(params, mesh, pspec),
                                  distribute_tree(batch, mesh, bspec))
        return gaps({"loss": loss0, "grad": g0}, {"loss": loss1, "grad": g1})

    def lm_decode(mesh, name, seq_split):
        arch = f32_lm(name)
        cfg = arch.cfg
        params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                at_rest=torch.float32)
        gen = torch.Generator().manual_seed(2)
        b, s = (1, 32) if seq_split else (4, 32)
        caches = {k: torch.randn(t.shape, generator=gen)
                  for k, t in arch._cache_struct(b, s).items()}
        token = torch.randint(0, cfg.vocab_size, (b,), generator=gen, dtype=torch.int32)
        # on the split sequence the position lies in the second slice
        position = torch.tensor([20] if seq_split else [3, 17, 31, 9], dtype=torch.int32)
        pspec, _ = arch.param_partition((params, None))
        cspec = arch._cache_spec(mesh, batch_sharded=not seq_split, seq_sharded=seq_split)
        tspec = P() if seq_split else P(dp_axes(mesh))
        plain = {k: v.clone() for k, v in caches.items()}
        dcaches = distribute_tree(caches, mesh, cspec)
        with use_mesh(mesh), torch.no_grad():
            logits0, _ = tf.decode(params, token, plain, position, cfg)
            logits1, _ = tf.decode(distribute_tree(params, mesh, pspec),
                                   distribute_tree(token, mesh, tspec), dcaches,
                                   distribute_tree(position, mesh, tspec), cfg)
        return gaps({"logits": logits0, "cache": plain}, {"logits": logits1, "cache": dcaches})

    def gnn_train(mesh, name):
        arch = get_arch(name)
        if arch.variant_builder is not None:
            arch = arch.variant(1)
        params = arch.smoke_params(torch.Generator().manual_seed(0), "cpu")
        batch = arch.smoke_batch(torch.Generator())
        step = value_and_grad(lambda p, b: (arch.smoke_loss(p, b), {}))
        pspec, _ = arch.param_partition((params, None))
        (_,), (bspec,) = arch.inputs(Cell(name, "full_graph_sm", "train"), mesh)
        with use_mesh(mesh):
            (loss0, _), g0 = step(params, batch)
            (loss1, _), g1 = step(distribute_tree(params, mesh, pspec),
                                  distribute_tree(batch, mesh, {k: bspec[k] for k in batch}))
        return gaps({"loss": loss0, "grad": g0}, {"loss": loss1, "grad": g1})

    def max_region(mesh):
        # every rank's [3, 5] block; element (0, 0) ties between the two
        # `data` rows of model rank 1, and nothing else ties
        n = mesh.size()
        blocks = torch.as_tensor(np.random.default_rng(3).permutation(n * 15).reshape(n, 3, 5),
                                 dtype=torch.float32)
        cols = mesh.size(1)
        blocks[1, 0, 0] = blocks[1 + cols, 0, 0] = float(n * 15)
        w = torch.as_tensor(np.random.default_rng(4).standard_normal((3, 5)),
                            dtype=torch.float32)
        every = blocks.clone().requires_grad_()
        (every.amax(0) * w).sum().backward()
        me = mesh.get_coordinate()[0] * cols + mesh.get_coordinate()[1]
        x = blocks[me].clone().requires_grad_()
        y = all_reduce_region(all_reduce_region(x, "max", mesh, "model"), "max", mesh, "data")
        (y * w).sum().backward()
        return gaps({"max": every.amax(0), "grad": every.grad[me]}, {"max": y, "grad": x.grad})

    cases = {
        "qwen3_train": lambda m: lm_train(m, "qwen3-0.6b"),
        "deepseek_train": lambda m: lm_train(m, "deepseek-v2-lite-16b"),
        "qwen3_decode": lambda m: lm_decode(m, "qwen3-0.6b", False),
        "qwen3_decode_seq": lambda m: lm_decode(m, "qwen3-0.6b", True),
        "deepseek_decode_seq": lambda m: lm_decode(m, "deepseek-v2-lite-16b", True),
        "gemma3_decode_seq": lambda m: lm_decode(m, "gemma3-27b", True),
        "equiformer_train": lambda m: gnn_train(m, "equiformer-v2"),
        "schnet_train": lambda m: gnn_train(m, "schnet"),
        "egnn_train": lambda m: gnn_train(m, "egnn"),
        "meshgraphnet_train": lambda m: gnn_train(m, "meshgraphnet"),
        "max_region": max_region,
    }
    try:
        mesh = init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=("data", "model"))
        with open(out_path, "w") as f:
            json.dump({c: cases[c](mesh) for c in cases_run}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), [int(s) for s in sys.argv[3].split("x")],
               sys.argv[4].split(","), sys.argv[5], sys.argv[6])
