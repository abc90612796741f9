"""Arch registry of the port: ``get_arch(name)`` / ``list_archs()``.

Lists the archs the port runs: the five LM archs and BST (the GNNs wait
for ROADMAP.md queue 1 item 2).  An arch is a minimal :class:`LMArch`
(name, full config, smoke config, family ``"lm"``) or :class:`RecsysArch`
(name, spec, smoke spec, family ``"recsys"``), each with the JAX package's
smoke-training pieces (``smoke_params``, ``smoke_batch``, ``smoke_loss``);
:func:`make_train_step` is ``configs/base.py``'s.  None of the JAX
package's dry-run machinery (shape cells, abstract inputs, sharding specs)
is carried over.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import transformer as tf
from ..models.recsys.bst import BSTSpec, bst_init, bst_loss
from ..models.transformer import LMConfig
from ..train.optimizer import OptConfig, adamw_update
from ..train.trainer import value_and_grad

__all__ = ["LMArch", "RecsysArch", "get_arch", "list_archs", "make_train_step"]

_MODULES = (
    "deepseek_v2_lite_16b",
    "granite_moe_3b_a800m",
    "yi_6b",
    "gemma3_27b",
    "qwen3_0_6b",
    "bst",
)


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig = OptConfig()) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the gradient of ``loss_fn`` (returning ``(loss, aux)``) and one AdamW
    step."""
    grad_fn = value_and_grad(loss_fn)

    def train_step(params, opt_state, batch):
        (loss, _), grads = grad_fn(params, batch)
        new_params, new_opt, _ = adamw_update(grads, opt_state, params, opt_cfg)
        return new_params, new_opt, loss

    return train_step


@dataclasses.dataclass(frozen=True)
class LMArch:
    name: str
    cfg: LMConfig
    smoke_cfg: LMConfig
    family: str = "lm"

    def smoke_params(self, generator: torch.Generator, device: DeviceLike = None):
        """The smoke config's params, f32 at rest as the JAX package's."""
        return tf.init_params(self.smoke_cfg, generator, device, at_rest=torch.float32)

    def smoke_batch(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Two sequences of 16 random token ids on the generator's device,
        the labels equal to the tokens."""
        tok = torch.randint(0, self.smoke_cfg.vocab_size, (2, 16), generator=generator,
                            device=generator.device)
        return {"tokens": tok, "labels": tok}

    def smoke_loss(self, params: Any, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return tf.train_loss(params, batch, self.smoke_cfg)[0]


@dataclasses.dataclass(frozen=True)
class RecsysArch:
    name: str
    spec: BSTSpec
    smoke_spec: BSTSpec
    family: str = "recsys"

    def smoke_params(self, generator: torch.Generator, device: DeviceLike = None):
        return bst_init(generator, self.smoke_spec, device)

    def smoke_batch(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Eight behaviour rows from ``numpy.random.default_rng(0)``, as the
        JAX package draws them (it ignores its key), on the generator's
        device."""
        rng = np.random.default_rng(0)
        B, L, sp = 8, self.smoke_spec.seq_len, self.smoke_spec
        batch = {
            "hist_items": rng.integers(0, sp.n_items, (B, L)),
            "hist_cats": rng.integers(0, sp.n_cats, (B, L)),
            "target_item": rng.integers(0, sp.n_items, B),
            "target_cat": rng.integers(0, sp.n_cats, B),
            "label": (rng.random(B) < 0.3).astype(np.float32),
        }
        dev = resolve_device(generator.device)
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def smoke_loss(self, params: Any, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return bst_loss(params, batch, self.smoke_spec)


def _archs() -> dict:
    mods = (importlib.import_module(f".{m}", __package__) for m in _MODULES)
    return {mod.ARCH.name: mod.ARCH for mod in mods}


def get_arch(name: str) -> Union[LMArch, RecsysArch]:
    archs = _archs()
    if name not in archs:
        raise KeyError(f"unknown or unported arch {name!r}; ported: {sorted(archs)}")
    return archs[name]


def list_archs() -> List[str]:
    return sorted(_archs())
