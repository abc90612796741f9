"""Activation sharding constraints (MaxText-style logical annotations).

Port of ``repro/distributed/constraints.py``.  ``constrain(x, *axes)`` pins
the intended layout of an activation: on a DTensor it ``redistribute``s to
the spec fitted to the DTensor's mesh, the counterpart of
``with_sharding_constraint``.  On a plain tensor it returns ``x`` itself, so
every single-device path runs exactly as before.  ``use_mesh`` marks the
mesh a step runs on (thread-local, as in the reference), for code that
has no DTensor in hand.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Tuple

from .sharding import fitted_spec, mesh_sizes, placements

__all__ = ["constrain", "current_mesh", "is_dtensor", "mesh_axes", "mesh_of", "pinned",
           "splittable", "use_mesh"]

_STATE = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` (a ``DeviceMesh``) for activation constraints.
    Inside, a plain tensor meeting a DTensor counts as replicated
    (``implicit_replication``): the model code makes its positions, masks
    and zero buffers as plain tensors, as on one device."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _STATE.mesh = prev


def current_mesh():
    return getattr(_STATE, "mesh", None)


def mesh_axes() -> Tuple[str, ...]:
    m = current_mesh()
    return tuple(m.mesh_dim_names) if m is not None else ()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def mesh_of(x):
    """The mesh a tensor lives on: a DTensor's own, else the active one.
    A DTensor carries its mesh into autograd's device threads (where a
    remat recompute runs), which see no thread-local state."""
    return x.device_mesh if is_dtensor(x) else current_mesh()


def constrain(x, *axes):
    """``x`` redistributed to ``P(*axes)`` fitted to its mesh (and its
    gradient to the same); ``x`` itself on a plain tensor or when nothing
    fits.  Entries may be None, a name, or a tuple of names; names missing
    from the mesh or not dividing the dim drop out (the reference's
    rule)."""
    if not is_dtensor(x) or len(axes) != x.dim():
        return x
    m = x.device_mesh
    spec = fitted_spec(tuple(x.shape), axes, m.mesh_dim_names, mesh_sizes(m))
    if spec is None:
        return x
    # a redistribute even to the same placements: its backward pins the
    # gradient to them too, as a sharding constraint's transpose does
    return x.redistribute(m, placements(spec, m))


def splittable(x, dim: int, n: int):
    """``x`` ready to have ``dim`` split into ``(n, -1)``: a DTensor whose
    ``dim`` is sharded over mesh dims whose sizes do not divide ``n`` is
    gathered on ``dim`` first (XLA reshards through such a reshape on its
    own; DTensor refuses it).  Anything else is returned as it is."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return x
    dim = dim % x.dim()
    split = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
    f = 1
    for i in split:
        f *= x.device_mesh.shape[i]
    if n % f == 0:
        return x
    pl = [Replicate() if i in split else p for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, pl)


def pinned(x):
    """A DTensor redistributed to its own placements: nothing moves, but its
    gradient is brought to the same placements on the way back (so a
    reshape's backward meets the layout its forward produced).  Anything
    else is returned as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, x.placements)
