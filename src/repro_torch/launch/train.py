"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains the arch's *smoke* config with the real :class:`Trainer`
(checkpointing, compression and failure injection all live), as the JAX
package's launcher does on its CPU container: ``TokenPipeline`` batches for
an LM, ``RecsysPipeline`` batches for BST, the arch's fixed smoke graph
every step for a GNN (full-batch training).  Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import itertools
import os
import tempfile

import torch

from ..configs import get_arch, list_archs
from ..data.pipeline import RecsysPipeline, TokenPipeline
from ..device import resolve_device
from ..distributed.fault import FailureSimulator
from ..train.optimizer import OptConfig
from ..train.trainer import Trainer, TrainerConfig


def make_data(arch, seed: int = 0):
    """The arch's batch stream (numpy arrays; the trainer moves them)."""
    if arch.family == "lm":
        cfg = arch.smoke_cfg
        return iter(TokenPipeline(cfg.vocab_size, batch=8, seq_len=32, seed=seed))
    if arch.family == "recsys":
        sp = arch.smoke_spec
        pipe = RecsysPipeline(sp.n_items, sp.n_cats, batch=8, seq_len=sp.seq_len, seed=seed)
        return (pipe.batch_at(step) for step in range(1 << 62))
    # gnn: fixed random graph batch each step (full-batch training)
    batch = {k: v.numpy() for k, v in
             arch.smoke_batch(torch.Generator().manual_seed(seed)).items()}
    return itertools.repeat(batch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs() + ["all"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--compression", default=None, choices=[None, "int8", "topk"])
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step (recovery demo)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    names = list_archs() if args.arch == "all" else [args.arch]
    for name in names:
        arch = get_arch(name)
        data = make_data(arch)
        params = arch.smoke_params(torch.Generator(device=dev).manual_seed(0), dev)
        sim = FailureSimulator([(args.fail_at, 1)]) if args.fail_at else None
        tcfg = TrainerConfig(
            total_steps=args.steps,
            ckpt_every=max(args.steps // 4, 1),
            ckpt_dir=f"{args.ckpt_dir}/{name}",
            grad_compression=args.compression,
            opt=OptConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps),
        )
        tr = Trainer(lambda p, b, a=arch: (a.smoke_loss(p, b), {}), params, tcfg,
                     failure_sim=sim, device=dev)
        metrics = tr.run(data)
        losses = metrics["loss"]
        print(
            f"[{name}] {len(losses)} steps  loss {losses[0]:.4f} -> {losses[-1]:.4f}"
            + (f"  recoveries={len(metrics.get('recoveries', []))}" if sim else "")
            + f"  ({dev})"
        )


if __name__ == "__main__":
    main()
