"""Config system: arch specs, shape cells, abstract inputs, step functions.

Port of ``repro/configs/base.py``.  Every arch is an instance of
:class:`LMArch`, :class:`GNNArch` or :class:`RecsysArch` that knows how to
(a) build its full and smoke model configs, (b) enumerate its (shape x
kind) cells with skip rules, (c) give the dry run its abstract state and
inputs with their specs, and (d) build the step function.

Abstract state: ``abstract_state`` / ``abstract_state_for`` build the
params and AdamW state as fake tensors (``FakeTensorMode``): shapes and
dtypes with no storage, so a 27B f32 state is never allocated.  Called
inside an active ``FakeTensorMode`` they use it, else they open one of
their own.  Inputs are :class:`TensorSpec` (the ``ShapeDtypeStruct``
counterpart); :func:`materialize` turns them into tensors.

FLOP accounting: the port's layer loops are eager Python loops, so a dry
run counts every layer and every edge chunk directly; ``depth_points`` and
``variant`` are kept for the extrapolation check, and
``Cell.flops_correction`` (the reference's multiplier for its
scan-undercounted equiformer-v2 chunk loop) is carried but not applied.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..distributed.sharding import (
    P, dp_axes, mesh_sizes, param_spec_bst, param_spec_gnn, param_spec_lm,
)
from ..models import transformer as tf
from ..models.gnn.common import graph_readout
from ..models.layers import cross_entropy, take_rows
from ..models.recsys.bst import (
    BSTSpec, bst_forward, bst_init, bst_loss, bst_user_state, retrieval_score,
)
from ..models.transformer import LMConfig
from ..train.optimizer import OptConfig, adamw_init, adamw_update
from ..train.trainer import value_and_grad

__all__ = [
    "Cell",
    "GNNArch",
    "GNNShape",
    "GNN_SHAPES",
    "LMArch",
    "LMShape",
    "LM_SHAPES",
    "RECSYS_SHAPES",
    "RecsysArch",
    "RecsysShape",
    "TensorSpec",
    "abstract_mode",
    "all_axes",
    "make_train_step",
    "materialize",
    "pad_to",
]

OPT = OptConfig()


def pad_to(n: int, mult: int = 512) -> int:
    return ((n + mult - 1) // mult) * mult


def all_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str  # train | prefill | decode | serve | retrieval
    skip: Optional[str] = None  # reason, if inapplicable
    flops_correction: float = 1.0  # the reference's scan multiplier (carried)

    @property
    def key(self) -> str:
        return f"{self.arch}/{self.shape}"


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of an abstract input (``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _sds(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(int(s) for s in shape), dtype)


def materialize(tree: Any, device: DeviceLike = "cpu") -> Any:
    """Each :class:`TensorSpec` of a nested tuple/dict as an uninitialised
    tensor (a fake one under ``FakeTensorMode``)."""
    if isinstance(tree, TensorSpec):
        return torch.empty(tree.shape, dtype=tree.dtype, device=torch.device(device))
    if isinstance(tree, dict):
        return {k: materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(materialize(v, device) for v in tree)
    return tree


@contextlib.contextmanager
def abstract_mode() -> Iterator[None]:
    """The active ``FakeTensorMode`` if there is one, else a new one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    if any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack()):
        yield
    else:
        with FakeTensorMode():
            yield


def _abstract_state(init: Callable[[torch.Generator], Any]) -> Tuple[Any, Any]:
    with abstract_mode():
        p = init(torch.Generator())
        return p, adamw_init(p)


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig = OPT) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the gradient of ``loss_fn`` (returning ``(loss, aux)``) and one AdamW
    step."""
    grad_fn = value_and_grad(loss_fn)

    def train_step(params, opt_state, batch):
        (loss, _), grads = grad_fn(params, batch)
        new_params, new_opt, _ = adamw_update(grads, opt_state, params, opt_cfg)
        return new_params, new_opt, loss

    return train_step


def _partition(pspec: Any) -> Tuple[Any, Any]:
    return pspec, {"mu": pspec, "nu": pspec, "step": P()}


# ---------------------------------------------------------------------------
# Shape tables (assigned)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    kind: str
    seq_len: int
    global_batch: int


LM_SHAPES = [
    LMShape("train_4k", "train", 4096, 256),
    LMShape("prefill_32k", "prefill", 32768, 32),
    LMShape("decode_32k", "decode", 32768, 128),
    LMShape("long_500k", "decode", 524288, 1),
]


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
class RecsysShape:
    name: str
    kind: str
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = [
    RecsysShape("train_batch", "train", 65536),
    RecsysShape("serve_p99", "serve", 512),
    RecsysShape("serve_bulk", "serve", 262144),
    RecsysShape("retrieval_cand", "retrieval", 1, pad_to(1_000_000)),
]


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LMArch:
    name: str
    cfg: LMConfig
    smoke_cfg: LMConfig
    sub_quadratic: bool = False
    ep_divisible: bool = True
    family: str = "lm"

    def depth_points(self) -> Optional[Tuple[int, int, int]]:
        """``(L_a, L_b, L_full)``: two shallow depths a whole number of
        local:global periods apart, for the depth extrapolation."""
        if self.cfg.local_global_ratio > 0:
            period = self.cfg.local_global_ratio + 1
            return (period, 2 * period, self.cfg.n_layers)
        return (1, 2, self.cfg.n_layers)

    def variant(self, depth: int) -> "LMArch":
        return dataclasses.replace(
            self, name=f"{self.name}@L{depth}",
            cfg=dataclasses.replace(self.cfg, n_layers=depth),
        )

    def cells(self) -> List[Cell]:
        out = []
        for s in LM_SHAPES:
            skip = None
            if s.name == "long_500k" and not self.sub_quadratic:
                skip = (
                    "pure full-attention arch: 500k-context decode requires "
                    "sub-quadratic attention (assignment skip rule; DESIGN §6)"
                )
            out.append(Cell(self.name, s.name, s.kind, skip))
        return out

    def shape(self, name: str) -> LMShape:
        return next(s for s in LM_SHAPES if s.name == name)

    def abstract_state(self) -> Tuple[Any, Any]:
        """(params, AdamW state) as fake tensors, every param f32."""
        return _abstract_state(
            lambda g: tf.init_params(self.cfg, g, "cpu", at_rest=torch.float32)
        )

    def param_partition(self, state: Tuple[Any, Any]) -> Tuple[Any, Any]:
        return _partition(param_spec_lm(state[0], self.ep_divisible, fsdp=True))

    def make_step(self, cell: Cell) -> Callable:
        cfg = self.cfg
        if cell.kind == "train":
            return make_train_step(lambda p, b: tf.train_loss(p, b, cfg))
        if cell.kind == "prefill":
            return lambda params, tokens: tf.prefill(params, tokens, cfg)
        if cell.kind == "decode":
            return lambda params, token, caches, position: tf.decode(
                params, token, caches, position, cfg
            )
        raise ValueError(cell.kind)

    def _cache_struct(self, B: int, S: int) -> Dict[str, TensorSpec]:
        c = self.cfg
        if c.mla:
            return {
                "c_kv": _sds((c.n_layers, B, S, c.kv_lora_rank), c.dtype),
                "k_rope": _sds((c.n_layers, B, S, c.qk_rope_dim), c.dtype),
            }
        return {
            "k": _sds((c.n_layers, B, c.n_kv_heads, S, c.hd), c.dtype),
            "v": _sds((c.n_layers, B, c.n_kv_heads, S, c.hd), c.dtype),
        }

    def _cache_spec(self, mesh, batch_sharded: bool, seq_sharded: bool) -> Dict[str, P]:
        c = self.cfg
        dp = dp_axes(mesh)
        b_ax = dp if batch_sharded else None
        s_ax = "data" if seq_sharded else None
        if seq_sharded:
            b_ax = None  # B=1 long-context
        if c.mla:
            return {
                "c_kv": P(None, b_ax, s_ax, "model"),
                "k_rope": P(None, b_ax, s_ax, None),
            }
        # shard kv-head axis when it divides the model axis, else head_dim
        if c.n_kv_heads % mesh_sizes(mesh)["model"] == 0:
            return {
                "k": P(None, b_ax, "model", s_ax, None),
                "v": P(None, b_ax, "model", s_ax, None),
            }
        return {
            "k": P(None, b_ax, None, s_ax, "model"),
            "v": P(None, b_ax, None, s_ax, "model"),
        }

    def inputs(self, cell: Cell, mesh) -> Tuple[Tuple, Tuple]:
        """(abstract args, spec trees), *excluding* params/opt."""
        s = self.shape(cell.shape)
        dp = dp_axes(mesh)
        B, S = s.global_batch, s.seq_len
        if cell.kind == "train":
            batch = {
                "tokens": _sds((B, S), torch.int32),
                "labels": _sds((B, S), torch.int32),
            }
            spec = {"tokens": P(dp, None), "labels": P(dp, None)}
            return (batch,), (spec,)
        if cell.kind == "prefill":
            return (_sds((B, S), torch.int32),), (P(dp, None),)
        if cell.kind == "decode":
            long_ctx = S > 100_000
            caches = self._cache_struct(B, S)
            cspec = self._cache_spec(mesh, batch_sharded=not long_ctx, seq_sharded=long_ctx)
            tok = _sds((B,), torch.int32)
            pos = _sds((B,), torch.int32)
            tspec = P(dp) if not long_ctx else P()
            return (tok, caches, pos), (tspec, cspec, tspec)
        raise ValueError(cell.kind)

    # smoke-training interface
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


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------
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
    flops_correction: Tuple[Tuple[str, float], ...] = ()
    family: str = "gnn"

    def depth_points(self) -> Optional[Tuple[int, int, int]]:
        if self.variant_builder is None:
            return None  # model is fully unrolled already (exact costing)
        return (1, 2, self.depth_full)

    def variant(self, depth: int) -> "GNNArch":
        init_fn, forward_fn = self.variant_builder(depth)
        return GNNArch(f"{self.name}@L{depth}", init_fn, forward_fn,
                       flops_correction=self.flops_correction)

    def cells(self) -> List[Cell]:
        fc = dict(self.flops_correction)
        return [Cell(self.name, s.name, "train", None, fc.get(s.name, 1.0))
                for s in GNN_SHAPES]

    def shape(self, name: str) -> GNNShape:
        return next(s for s in GNN_SHAPES if s.name == name)

    def _d_out(self, s: GNNShape) -> int:
        return s.n_classes if s.task == "node_class" else 1

    def abstract_state_for(self, shape_name: str) -> Tuple[Any, Any]:
        s = self.shape(shape_name)
        return _abstract_state(lambda g: self.init_fn(g, s.d_feat, self._d_out(s), True, "cpu"))

    def abstract_state(self) -> Tuple[Any, Any]:
        return self.abstract_state_for("full_graph_sm")

    def param_partition(self, state: Tuple[Any, Any]) -> Tuple[Any, Any]:
        return _partition(param_spec_gnn(state[0]))

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
                b["x"] = take_rows(batch["feats_resident"], batch["node_ids"].long())
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

    def make_step(self, cell: Cell) -> Callable:
        return make_train_step(self.loss_fn(cell.shape, full=True))

    def inputs(self, cell: Cell, mesh) -> Tuple[Tuple, Tuple]:
        s = self.shape(cell.shape)
        ax = all_axes(mesh)
        N, E = s.n_nodes, s.n_edges
        batch: Dict[str, Any] = {
            "pos": _sds((N, 3), torch.float32),
            "edge_src": _sds((E,), torch.int32),
            "edge_dst": _sds((E,), torch.int32),
            "edge_mask": _sds((E,), torch.bool),
            "node_mask": _sds((N,), torch.bool),
        }
        spec: Dict[str, Any] = {
            "pos": P(ax, None),
            "edge_src": P(ax),
            "edge_dst": P(ax),
            "edge_mask": P(ax),
            "node_mask": P(ax),
        }
        if s.resident_nodes:
            batch["feats_resident"] = _sds((s.resident_nodes, s.d_feat), torch.float32)
            spec["feats_resident"] = P(ax, None)
            batch["node_ids"] = _sds((N,), torch.int32)
            spec["node_ids"] = P(ax)
            batch["labels"] = _sds((N,), torch.int32)
            spec["labels"] = P(ax)
        else:
            batch["x"] = _sds((N, s.d_feat), torch.float32)
            spec["x"] = P(ax, None)
            if s.task == "node_class":
                batch["labels"] = _sds((N,), torch.int32)
                spec["labels"] = P(ax)
            else:
                batch["graph_id"] = _sds((N,), torch.int32)
                spec["graph_id"] = P(ax)
                batch["energy"] = _sds((s.n_graphs,), torch.float32)
                spec["energy"] = P()
        return (batch,), (spec,)

    # smoke-training interface
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


# ---------------------------------------------------------------------------
# Recsys family (BST)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RecsysArch:
    name: str
    spec: BSTSpec
    smoke_spec: BSTSpec
    family: str = "recsys"

    def depth_points(self) -> Optional[Tuple[int, int, int]]:
        return None  # no depth scan: the count is exact

    def cells(self) -> List[Cell]:
        return [Cell(self.name, s.name, s.kind) for s in RECSYS_SHAPES]

    def shape(self, name: str) -> RecsysShape:
        return next(s for s in RECSYS_SHAPES if s.name == name)

    def abstract_state(self) -> Tuple[Any, Any]:
        return _abstract_state(lambda g: bst_init(g, self.spec, "cpu"))

    def param_partition(self, state: Tuple[Any, Any]) -> Tuple[Any, Any]:
        return _partition(param_spec_bst(state[0]))

    def loss_fn(self) -> Callable:
        spec = self.spec

        def loss(params, batch):
            bce = bst_loss(params, batch, spec)
            return bce, {"bce": bce}

        return loss

    def make_step(self, cell: Cell) -> Callable:
        spec = self.spec
        if cell.kind == "train":
            return make_train_step(self.loss_fn())
        if cell.kind == "serve":
            return lambda params, batch: bst_forward(params, batch, spec)
        if cell.kind == "retrieval":
            def retrieve(params, batch):
                u = bst_user_state(params, batch, spec)
                return retrieval_score(params, u, batch["cand_ids"])

            return retrieve
        raise ValueError(cell.kind)

    def inputs(self, cell: Cell, mesh) -> Tuple[Tuple, Tuple]:
        s = self.shape(cell.shape)
        dp = dp_axes(mesh)
        sizes = mesh_sizes(mesh)
        B, L = s.batch, self.spec.seq_len
        b_ax = dp if B % int(np.prod([sizes[a] for a in dp])) == 0 else None
        batch = {
            "hist_items": _sds((B, L), torch.int32),
            "hist_cats": _sds((B, L), torch.int32),
            "target_item": _sds((B,), torch.int32),
            "target_cat": _sds((B,), torch.int32),
        }
        spec = {
            "hist_items": P(b_ax, None),
            "hist_cats": P(b_ax, None),
            "target_item": P(b_ax),
            "target_cat": P(b_ax),
        }
        if cell.kind == "train":
            batch["label"] = _sds((B,), torch.float32)
            spec["label"] = P(b_ax)
        if cell.kind == "retrieval":
            batch["cand_ids"] = _sds((B, s.n_candidates), torch.int32)
            spec["cand_ids"] = P(None, all_axes(mesh))
        return (batch,), (spec,)

    # smoke-training interface
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
