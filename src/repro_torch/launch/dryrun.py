"""Multi-pod dry run: run every (arch x shape x mesh) cell's step once on a
fake process group and record what a device of the mesh would do.

Port of ``repro/launch/dryrun.py``.  Where the reference lowers and compiles
each step for 256 or 512 forced host devices, the port runs it in one
process as rank 0 of a ``fake`` process group of that size
(:func:`repro_torch.launch.mesh.fake_world`): the state and inputs are
DTensors over a ``DeviceMesh`` whose local shards are fake tensors
(``FakeTensorMode``), so no 27B f32 state is ever allocated, and the
collectives return at once.  A dispatch mode below DTensor
(:class:`LocalCounter`) sees rank 0's local program, each op at its local
shapes, and records per cell:

  * ``flops_per_device``: the local ops' FLOPs by PyTorch's flop formulas
    (and the flash op's own, ``kernels/ops.py``);
  * ``bytes_accessed_per_device``: each local op's input and output bytes,
    summed op by op (an unfused count, not XLA's fused figure; views and
    metadata queries move none);
  * ``memory``: ``argument_bytes`` and ``output_bytes`` from the local
    shards of the step's arguments and results, and ``temp_bytes``, the
    peak of the live bytes the step's local ops allocated (tracked by
    storage, freed when the storage dies);
  * ``collectives``: each functional collective DTensor issued, by kind,
    with its result bytes and the ring wire bytes of its group
    (``roofline.wire_bytes``);
  * ``state_bytes_per_device``: params + optimizer state over their
    shardings, the reference's arithmetic.

The port's layer loops are eager, so the full depth is counted directly:
``corrected`` equals ``production`` and ``depth_points`` is recorded.

Usage:
  python -m repro_torch.launch.dryrun --mesh single --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --mesh both --all
"""
from __future__ import annotations

import argparse
import json
import os
import time
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import all_cells, get_arch
from ..configs.base import Cell, materialize
from ..distributed.constraints import use_mesh
from ..distributed.sharding import distribute_tree, state_bytes_per_device
from .mesh import fake_world, make_production_mesh
from .roofline import wire_bytes

__all__ = ["LocalCounter", "RESULTS_DIR", "main", "result_path", "run_cell"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "results")

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _collective_kind(packet) -> Optional[str]:
    """The reference's name for a collective op (``all-gather``, ...), or
    ``None`` for any other op."""
    ns = packet._qualified_op_name.split("::")[0]
    if ns == "_dtensor" and packet.__name__ == "shard_dim_alltoall":
        return "all-to-all"
    if ns in ("_c10d_functional", "c10d_functional"):
        return _COLLECTIVES.get(packet.__name__)
    return None


def _group_size(args) -> int:
    """Size of the process group a functional collective names (its last
    string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LocalCounter(TorchDispatchMode):
    """Counts the local program under DTensor: an op on DTensors is handed
    back (``NotImplemented``) so DTensor lowers it to local ops and
    collectives, which this mode then sees at their local shapes (the
    technique ``CommDebugMode`` uses for its collective census).

    DTensor infers an op's output shape by running the op once on fake
    tensors of the global shape (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``, cached per op schema); those runs
    pass through this mode too but are not part of the local program, so
    the mode wraps that method while active and counts nothing inside it."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._suspended = 0
        self._saved = None

    def _meta_method(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        for name in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"):
            if hasattr(ShardingPropagator, name):
                return ShardingPropagator, name
        raise RuntimeError("this torch's ShardingPropagator has no tensor-meta method to wrap")

    def __enter__(self):
        cls, name = self._meta_method()
        orig = getattr(cls, name)
        counter = self

        def meta_only(prop, op_schema):
            counter._suspended += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter._suspended -= 1

        self._saved = (cls, name, orig)
        setattr(cls, name, meta_only)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, name, orig = self._saved
        setattr(cls, name, orig)
        return super().__exit__(*exc)

    def _track(self, out: Any) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        packet = func._overloadpacket
        self.ops += 1
        if packet is torch.ops._c10d_functional.wait_tensor:
            return out  # hands back its collective's result: no bytes, no new storage
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs and not func.is_view:  # views and metadata queries move no bytes
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        kind = _collective_kind(packet)
        if kind is not None:
            nbytes = sum(_nbytes(t) for t in outs)
            g = _group_size(args)
            d = self.collectives.setdefault(
                kind, {"count": 0, "tensor_bytes": 0.0, "wire_bytes": 0.0})
            d["count"] += 1
            d["tensor_bytes"] += float(nbytes)
            d["wire_bytes"] += wire_bytes(kind, float(nbytes), g)
        self._track(out)
        return out


def _local_bytes(tree: Any) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            total += _nbytes(t.to_local())
        elif isinstance(t, torch.Tensor):
            total += _nbytes(t)
    return total


def count_cell(arch, cell: Cell, mesh) -> Dict[str, Any]:
    """Run one cell's step on ``mesh`` under ``FakeTensorMode`` and return
    its counts (the reference's ``_compile_cell`` record).  The fake
    tensors live on the mesh's device type."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = (arch.abstract_state_for(cell.shape) if hasattr(arch, "abstract_state_for")
                 else arch.abstract_state())
        pspec, ospec = arch.param_partition(state)
        step = arch.make_step(cell)
        in_args, in_specs = arch.inputs(cell, mesh)
        params = distribute_tree(state[0], mesh, pspec)
        args = [params]
        if cell.kind == "train":
            args.append(distribute_tree(state[1], mesh, ospec))
        args += [distribute_tree(materialize(a, mesh.device_type), mesh, s)
                 for a, s in zip(in_args, in_specs)]
        t_setup = time.perf_counter() - t0
        counter = LocalCounter()
        t0 = time.perf_counter()
        with use_mesh(mesh), torch.set_grad_enabled(cell.kind == "train"), counter:
            out = step(*args)
        t_run = time.perf_counter() - t0
        info = {
            "t_setup_s": round(t_setup, 2),
            "t_run_s": round(t_run, 2),
            "local_ops": counter.ops,
            "flops_per_device": float(counter.flops),
            "bytes_accessed_per_device": float(counter.bytes),
            "state_bytes_per_device": state_bytes_per_device(state, (pspec, ospec), mesh),
            "memory": {
                "argument_bytes": _local_bytes(args),
                "output_bytes": _local_bytes(out),
                "temp_bytes": int(counter.peak),
            },
            "collectives": counter.collectives,
        }
    return info


def run_cell(cell: Cell, mesh, mesh_name: str, arch=None) -> Dict[str, Any]:
    arch = arch or get_arch(cell.arch)
    rec: Dict[str, Any] = {
        "arch": cell.arch,
        "shape": cell.shape,
        "kind": cell.kind,
        "mesh": mesh_name,
        "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "flops_correction": cell.flops_correction,
        "device_type": mesh.device_type,
    }
    if cell.skip:
        rec["skipped"] = cell.skip
        return rec
    rec["production"] = count_cell(arch, cell, mesh)
    dp = arch.depth_points()
    if dp is not None:
        rec["depth_points"] = {"la": dp[0], "lb": dp[1], "lfull": dp[2]}
    p = rec["production"]
    # every layer and chunk ran eagerly: the production count is the full one
    rec["corrected"] = {
        "flops_per_device": p["flops_per_device"],
        "bytes_accessed_per_device": p["bytes_accessed_per_device"],
        "collectives": p["collectives"],
    }
    return rec


def result_path(mesh_name: str, cell: Cell, results_dir: Optional[str] = None) -> str:
    safe = f"{cell.arch}_{cell.shape}".replace("/", "_").replace(".", "_")
    return os.path.join(results_dir or RESULTS_DIR, f"dryrun_{mesh_name}_{safe}.json")


def run_cells(cells, multi: bool, force: bool = False, results_dir: Optional[str] = None,
              device_type: str = "cpu", log=print) -> Dict[str, Dict[str, Any]]:
    """Dry-run ``cells`` on the single (``multi=False``) or multi-pod mesh
    of ``device_type`` inside a fake world of its size; writes one JSON a
    cell and returns the records by cell key.  A cell that fails gets
    ``ok: false`` with its error.

    On a CPU mesh DTensor turns a shard-to-shard reshard into an all-gather
    and a chunk (gloo has no all-to-all); on a CUDA mesh it is an all-to-all,
    as on the cluster, so the census of record comes from a card."""
    results_dir = results_dir or RESULTS_DIR
    os.makedirs(results_dir, exist_ok=True)
    mesh_name = "multi" if multi else "single"
    out: Dict[str, Dict[str, Any]] = {}
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type=device_type)
        for cell in cells:
            path = result_path(mesh_name, cell, results_dir)
            if os.path.exists(path) and not force:
                log(f"[skip-existing] {mesh_name} {cell.key}")
                with open(path) as f:
                    out[cell.key] = json.load(f)
                continue
            log(f"[dryrun] {mesh_name} {cell.key} ...")
            t0 = time.perf_counter()
            try:
                rec = run_cell(cell, mesh, mesh_name)
                rec["ok"] = True
            except Exception as e:  # noqa: BLE001 - recorded per cell, as the reference
                rec = {
                    "arch": cell.arch, "shape": cell.shape, "mesh": mesh_name,
                    "ok": False, "error": f"{type(e).__name__}: {e}",
                }
                log(f"  FAILED: {rec['error']}")
            rec["wall_s"] = round(time.perf_counter() - t0, 1)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            out[cell.key] = rec
            if rec.get("ok") and "production" in rec:
                p = rec["production"]
                mem = p["memory"]
                log(f"  ok {rec['wall_s']}s  flops/dev={p['flops_per_device']:.3e}"
                    f"  args={mem['argument_bytes'] / 2**30:.2f}GiB"
                    f"  temp={mem['temp_bytes'] / 2**30:.2f}GiB")
            elif rec.get("skipped"):
                log(f"  SKIP: {rec['skipped'][:80]}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results-dir", default=None)
    args = ap.parse_args()

    cells = all_cells()
    if args.arch:
        cells = [c for c in cells if c.arch == args.arch]
    if args.shape:
        cells = [c for c in cells if c.shape == args.shape]
    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or filter with --arch/--shape")
    torch.set_num_threads(1)
    # the mesh of a card where there is one: its census is the cluster's
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    for multi in meshes:
        run_cells(cells, multi, force=args.force, results_dir=args.results_dir,
                  device_type=device_type, log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
