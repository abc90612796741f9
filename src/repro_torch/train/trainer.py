"""Fault-tolerant training loop.

Port of ``repro/train/trainer.py``: microbatch gradient accumulation in f32,
optional int8/top-k error-feedback gradient compression, async atomic
checkpoints with auto-resume, and failure injection -> elastic remesh ->
restore -> continue.  The JAX package's jitted update is an eager step
here: gradients by ``torch.autograd.grad`` over the param leaves, then
:func:`adamw_update` under ``no_grad``.  Everything runs on the trainer's
explicit device (``None`` = the card); batches arrive as numpy arrays (or
tensors, such as a feature table resident on the device) and are moved
there, and a restore puts the checkpoint back there.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..distributed import compression, fault
from .checkpoint import CheckpointManager, config_hash
from .optimizer import OptConfig, adamw_init, adamw_update, tree_leaves, tree_map, tree_paths

__all__ = ["Trainer", "TrainerConfig", "value_and_grad"]

LossFn = Callable[[Any, Dict[str, torch.Tensor]], Tuple[torch.Tensor, Dict]]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    log_every: int = 10
    microbatch: int = 1  # gradient-accumulation chunks per step
    grad_compression: Optional[str] = None  # None | "int8" | "topk"
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)


def value_and_grad(loss_fn: LossFn) -> Callable:
    """``f(params, batch) -> ((loss, aux), grads)``, ``grads`` shaped like
    ``params`` (the counterpart of ``jax.value_and_grad(..., has_aux=True)``;
    a leaf the loss does not reach gets zeros).
    The params themselves are not touched: the loss runs on detached
    leaves that require grad."""

    def f(params: Any, batch: Dict[str, torch.Tensor]):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, aux = loss_fn(live, batch)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not use has a zero gradient, as in JAX
        by_id = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)}
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
        return (loss.detach(), aux), tree_map(lambda p: by_id[id(p)], live)

    return f


class Trainer:
    def __init__(
        self,
        loss_fn: LossFn,
        params: Any,
        cfg: TrainerConfig,
        failure_sim: Optional[fault.FailureSimulator] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.params = tree_map(lambda p: p.to(self.device), params)
        self.opt_state = adamw_init(self.params)
        # the port's compression state is a flat dict (the JAX package maps
        # over the tree): one residual per "/"-joined leaf key
        self.comp_state = (
            compression.init_compression_state(dict(tree_paths(self.params)))
            if cfg.grad_compression
            else None
        )
        self.failure_sim = failure_sim
        # hash covers the state-compatibility surface only (schedule length
        # may legitimately change when extending a run)
        o = cfg.opt
        self.ckpt = CheckpointManager(
            cfg.ckpt_dir,
            config_hash=config_hash(
                (o.lr, o.b1, o.b2, o.eps, o.weight_decay, o.clip_norm, cfg.microbatch)
            ),
        )
        self.metrics: Dict[str, list] = {"loss": [], "step_time": []}
        self._grads = value_and_grad(loss_fn)

    # ------------------------------------------------------------- step fns
    def _update(self, params, opt_state, comp_state, batch):
        mb = self.cfg.microbatch
        if mb > 1:
            # split the batch into microbatches and accumulate grads in f32;
            # the optimizer (and any cross-pod reduction) runs once a step
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(mb):
                sub = {k: x[i * (x.shape[0] // mb):(i + 1) * (x.shape[0] // mb)]
                       for k, x in batch.items()}
                (l, _), g = self._grads(params, sub)
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
                del g
            loss = loss / mb
            grads = tree_map(lambda g: g / mb, grads)
        else:
            (loss, _), grads = self._grads(params, batch)

        if self.cfg.grad_compression and comp_state is not None:
            # error-feedback compression (the psum itself is implicit in
            # sharded training; the EF quantization models the wire format)
            keys = dict(tree_paths(grads))
            pairs = {key: compression.apply_error_feedback(
                g, comp_state[key], self.cfg.grad_compression) for key, g in keys.items()}
            comp_state = {key: r for key, (_, r) in pairs.items()}
            grads = _unflat(grads, {key: g for key, (g, _) in pairs.items()})
        new_params, new_opt, info = adamw_update(grads, opt_state, params, self.cfg.opt)
        return new_params, new_opt, comp_state, loss, info

    # ---------------------------------------------------------------- loop
    def _state(self) -> Dict[str, Any]:
        return {"params": self.params, "opt": self.opt_state}

    def run(self, data: Iterator[Dict[str, np.ndarray]], resume: bool = True) -> Dict:
        start = 0
        if resume:
            step, restored = self.ckpt.restore_latest(self._state())
            if step is not None:
                self.params = restored["params"]
                self.opt_state = restored["opt"]
                start = step
        it = iter(data)
        for step in range(start, self.cfg.total_steps):
            if self.failure_sim is not None:
                ev = self.failure_sim.check(step)
                if ev is not None:
                    # node failure: restore from last checkpoint, remesh
                    self.recover_from_failure(ev)
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v),
                                        device=self.device)
                     for k, v in next(it).items()}
            self.params, self.opt_state, self.comp_state, loss, info = self._update(
                self.params, self.opt_state, self.comp_state, batch
            )
            loss = float(loss)  # waits for the step
            dt = time.perf_counter() - t0
            self.metrics["loss"].append(loss)
            self.metrics["step_time"].append(dt)
            if (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, self._state())
        self.ckpt.wait()  # drain any in-flight periodic save first
        self.ckpt.save(self.cfg.total_steps, self._state(), block=True)
        return self.metrics

    def recover_from_failure(self, ev: fault.FailureEvent) -> None:
        """Checkpoint-restore recovery path.  On a real cluster this runs on
        the surviving hosts with an elastic remesh (fault.elastic_mesh_shape)
        before restoring; with one device the restore path still runs.  Its
        record in ``metrics["recoveries"]`` holds the restore's seconds."""
        self.ckpt.wait()  # quiesce in-flight async saves before restoring
        t0 = time.perf_counter()
        step, restored = self.ckpt.restore_latest(self._state())
        if step is not None:
            self.params = restored["params"]
            self.opt_state = restored["opt"]
        restore_s = time.perf_counter() - t0
        n_visible = torch.cuda.device_count() if self.device.type == "cuda" else 1
        shape, axes = fault.elastic_mesh_shape(max(n_visible - ev.n_failed, 1))
        self.metrics.setdefault("recoveries", []).append(
            {"at_step": ev.step, "restored_step": step, "new_mesh": (shape, axes),
             "restore_s": restore_s}
        )


def _unflat(template: Any, flat: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    """``template``'s structure with each leaf taken from ``flat`` by key."""
    if isinstance(template, dict):
        return {k: _unflat(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    return flat[prefix[:-1]]
