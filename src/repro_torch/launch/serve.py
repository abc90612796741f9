"""Serving launcher: continuous-batching engine on an LM arch's smoke config.

``python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8``

``--arch`` takes any LM-family arch of the registry (MLA or GQA).

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch, list_archs
from ..device import resolve_device
from ..models import transformer as tf
from ..serve.engine import Engine, Request, ServeConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    lm_archs = [a for a in list_archs() if get_arch(a).family == "lm"]
    ap.add_argument("--arch", default="qwen3-0.6b", choices=lm_archs)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    arch = get_arch(args.arch)
    cfg = arch.smoke_cfg
    dev = resolve_device(args.device)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(params, cfg, ServeConfig(n_slots=args.slots, max_len=128), device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        eng.submit(
            Request(
                rid=i,
                prompt=rng.integers(0, cfg.vocab_size, plen),
                max_new_tokens=args.max_new,
            )
        )
    done = eng.run_to_completion()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(
        f"[{args.arch}] served {len(done)} requests, {toks} tokens in {dt:.2f}s "
        f"({toks/dt:.1f} tok/s, {args.slots} slots, continuous batching, {dev})"
    )


if __name__ == "__main__":
    main()
