"""Production mesh construction.

Port of ``repro/launch/mesh.py`` on ``torch.distributed``: a mesh is a
``DeviceMesh`` over the default process group.  Single-pod: (data=16,
model=16) = 256 ranks.  Multi-pod: (pod=2, data=16, model=16) = 512 ranks;
the ``pod`` axis maps to the slow links between nodes, the latency layer
the GeoLayer machinery treats as ``Layer_2`` (``distributed/geo_sharding.
mesh_env``).

A dry run needs no cluster: :func:`fake_world` opens a process group of the
``fake`` backend, whose collectives return at once, in one process; this
process is then rank 0 of ``n``.  Nothing here runs at import time.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

__all__ = ["AbstractMesh", "fake_world", "make_cpu_mesh", "make_production_mesh"]


class AbstractMesh:
    """A mesh's axis names and sizes with no process group behind it
    (``jax.sharding.AbstractMesh``): enough for spec arithmetic, state
    bytes and a cell's inputs."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]) -> None:
        if len(shape) != len(names):
            raise ValueError(f"{len(shape)} sizes for {len(names)} axis names")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(names)
        self.ndim = len(self.shape)


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The ``(16, 16)`` ``("data", "model")`` mesh, or ``(2, 16, 16)``
    ``("pod", "data", "model")``, over the default process group's first
    ranks.  Raises ``RuntimeError`` when the world has fewer ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = _world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; have {have} — run inside "
            f"repro_torch.launch.mesh.fake_world({n}) (the dry run opens one) or a "
            "process group of that size"
        )
    if have != n:
        raise RuntimeError(f"mesh {shape} needs a world of exactly {n} ranks, have {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_cpu_mesh(shape: Sequence[int] = (1, 1), axes: Sequence[str] = ("data", "model"),
                  device_type: str = "cpu"):
    """Degenerate mesh over the whole (small) world, ``(1, 1)`` by default."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0) -> Iterator[None]:
    """A ``fake`` process group of ``n`` ranks in this process (as
    ``rank``), destroyed on exit whatever happens inside.  Raises when a
    process group is already open."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
