"""Sharding rules: logical param/batch axes -> mesh axes, per arch family.

Port of ``repro/distributed/sharding.py``.  A path-based rule table maps each
parameter leaf to a :class:`P` (a ``PartitionSpec``: one entry a dim, each
``None``, a mesh-axis name or a tuple of names).  Mesh axes:
  * ``pod``   — data parallelism across pods (the slow links)
  * ``data``  — data parallelism within a pod
  * ``model`` — tensor/expert/vocab/row parallelism
Sequence sharding (long-context KV) reuses ``data``.

The rules return the JAX package's specs leaf for leaf.  What the port adds
is the step from a spec to DTensor placements on a ``DeviceMesh``
(:func:`placements`): mesh dim ``i`` gets ``Shard(d)`` when its name
appears in entry ``d``, else ``Replicate()``.  An entry naming two axes
(``("pod", "data")``) becomes two ``Shard(d)`` placements; DTensor splits a
dim over mesh dims in mesh order, which is JAX's major-to-minor order only
when the entry lists its axes in mesh order, so :func:`placements` raises on
any other order.  :func:`distribute_tree` is ``tree_shardings`` plus the
``device_put``: it lays a tree of tensors out on the mesh.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "P",
    "axis_rank",
    "batch_spec_lm",
    "constrain_lm_layer",
    "distribute_tree",
    "dp_axes",
    "param_spec_bst",
    "param_spec_gnn",
    "param_spec_lm",
    "placements",
    "shard_factor",
    "spec_tree_map",
]


class P(tuple):
    """A ``PartitionSpec``: ``P(None, "model")``, ``P(("pod", "data"), None)``;
    ``P()`` replicates.  A one-name tuple entry is that name, as JAX
    normalises it."""

    def __new__(cls, *axes):
        return super().__new__(
            cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in axes)
        )

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present in this mesh (('pod','data') or ('data',))."""
    names = _axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(_axis_names(mesh), mesh.shape))


def axis_rank(mesh, axes: Sequence[str]) -> int:
    """This rank's index among the pieces ``axes`` (mesh axis names, major
    to minor) cut a dim into: 0 for no axes."""
    r = 0
    for a in axes:
        r = r * mesh.size(_axis_names(mesh).index(a)) + mesh.get_local_rank(a)
    return r


def shard_factor(spec: P, mesh) -> int:
    """Number of pieces a leaf with ``spec`` is cut into on ``mesh``."""
    sizes = mesh_sizes(mesh)
    f = 1
    for entry in spec:
        for a in _names(entry):
            f *= sizes[a]
    return f


def placements(spec: Sequence, mesh) -> List[Any]:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim ``i`` gets
    ``Shard(d)`` if its name appears in entry ``d``, else ``Replicate()``.
    Raises when an entry names an axis the mesh lacks, names one axis
    twice, or lists two axes out of mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    out: List[Any] = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        axes = _names(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names {a!r}, not an axis of {names}")
            if a in seen:
                raise ValueError(f"spec {tuple(spec)} names {a!r} twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry!r} lists its axes out of mesh order {names}; DTensor "
                "splits a dim over mesh dims in mesh order"
            )
        for i in idx:
            out[i] = Shard(d)
    return out


def _lm_rule(path: str, rank: int, ep_divisible: bool = True) -> P:
    """PartitionSpec for one LM param leaf, *excluding* the stacked-L axis.

    ``rank`` is the per-layer rank (disambiguates dense [dff,d] vs MoE
    [E,dff,d] weights sharing path suffixes).  ``ep_divisible``: experts
    shard over ``model`` when E % model == 0, else the expert hidden dim
    shards (TP-within-expert, e.g. granite's 40 experts on 16 shards)."""
    # attention
    if path.endswith("attn.wq") or path.endswith("attn.wk") or path.endswith("attn.wv"):
        return P(None, "model")
    if path.endswith("attn.wo"):
        return P("model", None)
    if path.endswith("attn.w_uk") or path.endswith("attn.w_uv"):
        return P(None, "model")  # MLA up-projections: heads sharded
    if path.endswith("attn.w_dkv") or path.endswith("attn.w_krope"):
        return P(None, None)  # small latent projections: replicated
    # MoE expert weights are 3D per layer: [E, d, f] / [E, f, d]
    if rank == 3 and (path.endswith("ffn.w_gate") or path.endswith("ffn.w_up")):
        return P("model", None, None) if ep_divisible else P(None, None, "model")
    if rank == 3 and path.endswith("ffn.w_down"):
        return P("model", None, None) if ep_divisible else P(None, "model", None)
    if path.endswith("ffn.router"):
        return P(None, None)
    if "shared_gate" in path or "shared_up" in path:
        return P(None, "model")
    if "shared_down" in path:
        return P("model", None)
    # dense FFN (2D per layer)
    if path.endswith("ffn.w_gate") or path.endswith("ffn.w_up"):
        return P(None, "model")
    if path.endswith("ffn.w_down"):
        return P("model", None)
    # embeddings: vocab-sharded
    if path.endswith("embed.table") or path.endswith("unembed.table"):
        return P("model", None)
    return P()  # norms, gains, biases: replicated


def _path_str(path: Sequence) -> str:
    return ".".join(str(k) for k in path)


def spec_tree_map(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of nested dicts (``path`` the
    tuple of keys), keeping the structure."""
    if isinstance(tree, dict):
        return {k: spec_tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _fsdp_axes(base: Sequence, shape: Sequence[int], rank: int) -> List:
    """``base`` padded to ``rank`` with the largest un-sharded dim that 16
    divides (the first such) sharded over ``data``, unless ``data`` is
    already used."""
    axes = list(base) + [None] * (rank - len(base))
    if "data" not in axes:
        for i in range(rank):
            if axes[i] is None and shape[i] % 16 == 0:
                axes[i] = "data"
                break
    return axes


def param_spec_lm(params_tree: Any, ep_divisible: bool = True, fsdp: bool = False) -> Any:
    """Spec tree for LM params (stacked-layer layout aware).

    ``fsdp=True`` additionally shards the non-``model`` dim of every 2D+
    weight over ``data`` (ZeRO-3 style); each layer's weights are gathered
    where the layer uses them."""

    def rule(path, leaf):
        s = _path_str(path)
        stacked = s.startswith("layers.")
        ndim = len(leaf.shape)
        rank = ndim - 1 if stacked else ndim
        base = _lm_rule(s, rank, ep_divisible)
        if fsdp and rank >= 2:
            base = P(*_fsdp_axes(base, tuple(leaf.shape)[1 if stacked else 0:], rank))
        if stacked and len(base) < ndim:  # prepend None for the L axis
            return P(*((None,) * (ndim - len(base)) + tuple(base)))
        if len(base) > ndim:
            return P(*base[:ndim])
        return base

    return spec_tree_map(rule, params_tree)


def param_spec_gnn(params_tree: Any) -> Any:
    """GNN params are small (<= ~35M); replicate everywhere."""
    return spec_tree_map(lambda path, leaf: P(), params_tree)


def param_spec_bst(params_tree: Any) -> Any:
    """BST: embedding tables row-sharded over ``model``; the rest replicated."""

    def rule(path, leaf):
        s = _path_str(path)
        if s.endswith("item_table") or s.endswith("cat_table"):
            return P("model", None)
        return P()

    return spec_tree_map(rule, params_tree)


def batch_spec_lm(mesh, kind: str) -> Dict[str, P]:
    """Input specs per shape kind."""
    dp = dp_axes(mesh)
    if kind == "train":
        return {"tokens": P(dp, None), "labels": P(dp, None)}
    if kind == "prefill":
        return {"tokens": P(dp, None)}
    if kind == "decode":
        # caches handled separately (configs.base.LMArch.inputs)
        return {"token": P(dp), "position": P(dp)}
    raise ValueError(kind)


def _distribute(x: Any, spec: Sequence, mesh) -> Any:
    """``x`` laid out on ``mesh`` by ``spec``: a DTensor passes through
    ``redistribute``; a tensor is cut on each rank from its full value
    (``src_data_rank=None``: no communication, every rank holds the whole
    tensor, as a checkpoint restore or a seeded init does)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def distribute_tree(tree: Any, mesh, spec_tree: Any) -> Any:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` with its spec from
    ``spec_tree`` (the same nested dicts); the JAX package's
    ``tree_shardings`` + ``device_put``."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, spec_tree[k]) for k, v in tree.items()}
    return _distribute(tree, spec_tree, mesh)


def constrain_lm_layer(lp: Any, ep_divisible: bool = True, fsdp: bool = True) -> Any:
    """Re-pin one layer's weight shardings where the layer runs.

    The reference pins them inside its scan body so the FSDP all-gather of
    the stacked ``[L, ...]`` arrays stays in the loop.  The port's loop is
    eager and unbinds the stack, so the pin holds each layer's slice to its
    own spec: a no-op on a slice that already has it, and on a plain
    tensor."""
    from .constraints import constrain

    def pin(path, leaf):
        if leaf.dim() < 2:
            return leaf
        s = _path_str(path)
        base = _lm_rule(s, leaf.dim(), ep_divisible)
        axes = list(base) + [None] * (leaf.dim() - len(base))
        if fsdp:
            axes = _fsdp_axes(base, tuple(leaf.shape), leaf.dim())
        return constrain(leaf, *axes[: leaf.dim()])

    return spec_tree_map(pin, lp)


def state_bytes_per_device(state: Any, spec_tree: Any, mesh) -> float:
    """Bytes of a state tree a device holds under ``spec_tree``: each leaf's
    whole bytes over its shard factor, the JAX package's dry-run arithmetic
    (uneven splits are not rounded up, as there)."""
    total = 0.0

    def walk(leaf, spec):
        nonlocal total
        if isinstance(leaf, dict):
            for k in leaf:
                walk(leaf[k], spec[k])
            return
        if isinstance(leaf, (tuple, list)):
            for sub, sp in zip(leaf, spec):
                walk(sub, sp)
            return
        n = 1
        for s in leaf.shape:
            n *= int(s)
        total += float(n * leaf.dtype.itemsize) / shard_factor(spec, mesh)

    walk(state, spec_tree)
    return total


def fitted_spec(shape: Sequence[int], axes: Sequence, names: Sequence[str],
                sizes: Dict[str, int]) -> Optional[Tuple]:
    """The reference ``constrain``'s ``fit`` rule: each entry keeps the
    names the mesh has, and drops out when their product does not divide
    the dim.  ``None`` when every entry drops out (no constraint)."""
    present = set(names)

    def fit(a, dim):
        ns = tuple(n for n in _names(a) if n in present)
        if not ns:
            return None
        f = 1
        for n in ns:
            f *= sizes[n]
        if dim % f != 0:
            return None
        return ns if len(ns) > 1 else ns[0]

    spec = tuple(fit(a, int(d)) for a, d in zip(axes, shape))
    return None if all(s is None for s in spec) else spec
