"""Arch registry of the port: ``get_arch(name)`` / ``list_archs()``.

Lists every arch of the JAX package: the five LM archs, BST and the four
GNNs.  An arch is a minimal :class:`LMArch` (name, full config, smoke
config, family ``"lm"``), :class:`RecsysArch` (name, spec, smoke spec,
family ``"recsys"``) or :class:`GNNArch` (name, init and forward functions,
family ``"gnn"``), each with the JAX package's smoke-training pieces
(``smoke_params``, ``smoke_batch``, ``smoke_loss``); :func:`make_train_step`
is ``configs/base.py``'s.  The GNN half of ``configs/base.py`` is here too:
:func:`pad_to`, :class:`GNNShape`, :data:`GNN_SHAPES` and
:class:`GNNArch`'s losses on them.  None of the JAX package's dry-run
machinery (shape cells, abstract inputs, sharding specs) is carried over.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import transformer as tf
from ..models.gnn.common import graph_readout
from ..models.layers import cross_entropy
from ..models.recsys.bst import BSTSpec, bst_init, bst_loss
from ..models.transformer import LMConfig
from ..train.optimizer import OptConfig, adamw_update
from ..train.trainer import value_and_grad

__all__ = [
    "GNNArch",
    "GNNShape",
    "GNN_SHAPES",
    "LMArch",
    "RecsysArch",
    "get_arch",
    "list_archs",
    "make_train_step",
    "pad_to",
]

_MODULES = (
    "deepseek_v2_lite_16b",
    "granite_moe_3b_a800m",
    "yi_6b",
    "gemma3_27b",
    "qwen3_0_6b",
    "egnn",
    "meshgraphnet",
    "equiformer_v2",
    "schnet",
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


def pad_to(n: int, mult: int = 512) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int  # feature dim (or n_species for int features)
    n_classes: int
    task: str  # node_class | graph_reg
    n_graphs: int = 1
    resident_nodes: int = 0  # minibatch: resident feature-table rows
    seeds: int = 0  # minibatch: #seed nodes with labels
    int_features: bool = False


GNN_SHAPES = [
    GNNShape("full_graph_sm", pad_to(2708), pad_to(10556), 1433, 7, "node_class"),
    # reddit-scale sampled block: 1024 seeds, fanout 15-10
    GNNShape(
        "minibatch_lg",
        pad_to(1024 + 1024 * 15 + 1024 * 150),
        pad_to(1024 * 15 + 1024 * 150),
        602,
        41,
        "node_class",
        resident_nodes=pad_to(232_965),
        seeds=1024,
    ),
    GNNShape(
        "ogb_products", pad_to(2_449_029), pad_to(61_859_140), 100, 47, "node_class"
    ),
    GNNShape(
        "molecule", pad_to(128 * 30), pad_to(128 * 64), 16, 0, "graph_reg",
        n_graphs=128, int_features=False,
    ),
]


@dataclasses.dataclass(frozen=True)
class GNNArch:
    """GNN arch: ``init_fn(generator, d_in, d_out, full, device)`` draws
    params on ``device`` from ``generator`` (which must live there) and
    ``forward_fn(params, batch, full, shape_name)`` -> [N, d_out]."""

    name: str
    init_fn: Callable
    forward_fn: Callable
    variant_builder: Optional[Callable] = None
    depth_full: int = 0
    family: str = "gnn"

    def depth_points(self) -> Optional[Tuple[int, int, int]]:
        if self.variant_builder is None:
            return None  # model is fully unrolled already (exact costing)
        return (1, 2, self.depth_full)

    def variant(self, depth: int) -> "GNNArch":
        init_fn, forward_fn = self.variant_builder(depth)
        return GNNArch(f"{self.name}@L{depth}", init_fn, forward_fn)

    def shape(self, name: str) -> GNNShape:
        return next(s for s in GNN_SHAPES if s.name == name)

    def _d_out(self, s: GNNShape) -> int:
        return s.n_classes if s.task == "node_class" else 1

    def loss_fn(self, shape_name: str, full: bool = True) -> Callable:
        """``loss(params, batch) -> (loss, aux)`` on ``shape_name``: masked
        node CE on a full graph, CE on the seeds of a sampled block (whose
        features are gathered from ``feats_resident`` by ``node_ids``), or
        the MSE of each graph's summed output against its ``energy``."""
        s = self.shape(shape_name)
        fwd = self.forward_fn

        def loss(params, batch):
            b = dict(batch)
            if s.resident_nodes:  # gather sampled-block features on device
                b["x"] = batch["feats_resident"][batch["node_ids"].long()]
            out = fwd(params, b, full, s.name)
            if s.task == "node_class":
                if s.seeds:  # minibatch: loss on seed nodes only
                    ce = cross_entropy(out[: s.seeds], batch["labels"][: s.seeds])
                else:
                    ce = cross_entropy(out, batch["labels"], mask=batch["node_mask"].float())
                return ce, {"ce": ce}
            # graph regression: masked sum-readout per graph
            e = graph_readout(
                out, batch["graph_id"].long(), s.n_graphs, batch["node_mask"]
            )[:, 0]
            mse = torch.mean((e - batch["energy"]) ** 2)
            return mse, {"mse": mse}

        return loss

    def make_step(self, shape_name: str) -> Callable:
        return make_train_step(self.loss_fn(shape_name, full=True))

    def smoke_params(self, generator: torch.Generator, device: DeviceLike = None):
        return self.init_fn(generator, 8, 3, False, device)

    def smoke_batch(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """A random graph of 24 nodes and 48 edges from
        ``numpy.random.default_rng(0)``, as the JAX package draws it (it
        ignores its key), on the generator's device."""
        rng = np.random.default_rng(0)
        n, e = 24, 48
        batch = {
            "x": rng.standard_normal((n, 8)).astype(np.float32),
            "pos": rng.standard_normal((n, 3)).astype(np.float32),
            "edge_src": rng.integers(0, n, e).astype(np.int32),
            "edge_dst": rng.integers(0, n, e).astype(np.int32),
            "edge_mask": np.ones((e,), bool),
            "node_mask": np.ones((n,), bool),
            "labels": rng.integers(0, 3, n).astype(np.int32),
        }
        dev = resolve_device(generator.device)
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def smoke_loss(self, params: Any, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = self.forward_fn(params, batch, False, None)
        return cross_entropy(out, batch["labels"])


def _archs() -> dict:
    mods = (importlib.import_module(f".{m}", __package__) for m in _MODULES)
    return {mod.ARCH.name: mod.ARCH for mod in mods}


def get_arch(name: str) -> Union[LMArch, RecsysArch, GNNArch]:
    archs = _archs()
    if name not in archs:
        raise KeyError(f"unknown or unported arch {name!r}; ported: {sorted(archs)}")
    return archs[name]


def list_archs() -> List[str]:
    return sorted(_archs())
