"""The port's sharding rules, activation constraints, production mesh and
``reshard_tree`` against the JAX package.

- Every leaf of every arch's full config has the JAX package's spec
  exactly (the JAX side by ``jax.eval_shape``, the port's by its fake
  abstract state), for ``fsdp`` on and off and granite's ``ep_divisible``
  both ways; GNN and BST leaves too.
- ``constrain``'s fitted spec equals the reference ``constrain``'s at each
  call site's shape on the ``(16, 16)``, ``(2, 16, 16)`` and ``(2, 4)``
  meshes (the JAX side in a subprocess with 512 forced CPU devices, the
  spec read where it calls ``with_sharding_constraint``), and on a fake
  ``(2, 4)`` mesh the port's ``constrain`` lays a DTensor out by it.
- With no mesh, or on a plain tensor, ``constrain`` returns its argument.
- ``make_production_mesh`` raises with fewer ranks (``tests/test_launch.py``).
- ``reshard_tree``'s local shard on each rank of a fake ``(2, 4)`` mesh
  equals the slice JAX gives that device, multi-axis entries included.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.distributed import sharding as jsh
from repro_torch.configs import get_arch, list_archs
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.constraints import constrain, current_mesh, use_mesh
from repro_torch.distributed.fault import reshard_tree
from repro_torch.launch.mesh import fake_world, make_cpu_mesh, make_production_mesh

LMS = ["deepseek-v2-lite-16b", "gemma3-27b", "granite-moe-3b-a800m", "qwen3-0.6b", "yi-6b"]
GNNS = ["egnn", "equiformer-v2", "meshgraphnet", "schnet"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((2, 4), ("data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_ref(tree):
    """{dotted path: spec tuple} of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jsh._path_str(p): tuple(s) for p, s in leaves}


def _flat_port(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, prefix + (k,)))
        return out
    return {".".join(prefix): tuple(tree)}


_STATES = {}


def _port_params(name, shape=None):
    key = (name, shape)
    if key not in _STATES:
        arch = get_arch(name)
        state = arch.abstract_state_for(shape) if shape else arch.abstract_state()
        _STATES[key] = state[0]
    return _STATES[key]


def _ref_params(name, shape=None):
    arch = jax_arch(name)
    state = arch.abstract_state_for(shape) if shape else arch.abstract_state()
    return state[0]


@pytest.mark.parametrize("name", LMS)
def test_lm_param_specs_equal_reference(name):
    ours, ref = _port_params(name), _ref_params(name)
    eps = (True, False) if name == "granite-moe-3b-a800m" else (get_arch(name).ep_divisible,)
    for ep in eps:
        for fsdp in (True, False):
            want = _flat_ref(jsh.param_spec_lm(ref, ep, fsdp=fsdp))
            got = _flat_port(tsh.param_spec_lm(ours, ep, fsdp=fsdp))
            assert got == want, (ep, fsdp)
    # the arch's partition (params, and AdamW's mu/nu/step) as the reference's
    jp, jo = jax_arch(name).param_partition(jax_arch(name).abstract_state())
    tp, to = get_arch(name).param_partition((ours, None))
    assert _flat_port(tp) == _flat_ref(jp)
    assert _flat_port(to) == _flat_ref(jo)


@pytest.mark.parametrize("name", GNNS + ["bst"])
def test_gnn_and_bst_param_specs_equal_reference(name):
    shape = "ogb_products" if name in GNNS else None
    ours, ref = _port_params(name, shape), _ref_params(name, shape)
    rule = tsh.param_spec_bst if name == "bst" else tsh.param_spec_gnn
    jrule = jsh.param_spec_bst if name == "bst" else jsh.param_spec_gnn
    got, want = _flat_port(rule(ours)), _flat_ref(jrule(ref))
    assert got == want
    if name == "bst":
        assert got["item_table"] == ("model", None)


def test_port_leaves_are_the_references():
    """The port's abstract state has the reference's leaves, shapes and
    dtypes (what the spec and state-bytes equalities rest on)."""
    for name in LMS + ["bst"]:
        ours = {k: v for k, v in _flat_leaves(_port_params(name)).items()}
        ref = jax.tree_util.tree_flatten_with_path(_ref_params(name))[0]
        want = {jsh._path_str(p): (tuple(x.shape), str(x.dtype)) for p, x in ref}
        assert ours == want, name


def _flat_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, prefix + (k,)))
        return out
    return {".".join(prefix): (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


# --------------------------------------------------------------- constrain
def _call_sites():
    """(shape, axes) of the reference's ``constrain`` call sites at each
    arch's train, prefill and decode shapes, and the GNN ``shard_ragged``
    sites at each GNN shape."""
    from repro_torch.configs.base import GNN_SHAPES, LM_SHAPES

    dp = ("pod", "data")
    sites = []
    for name in LMS:
        c = get_arch(name).cfg
        for s in LM_SHAPES[:3]:
            b, t = s.global_batch, s.seq_len if s.kind != "decode" else 1
            hq = c.n_heads
            sites += [((b, t, c.d_model), (dp, "model", None)),
                      ((b, hq, t, c.hd), (dp, "model", None, None)),
                      ((b, c.n_kv_heads, t, c.hd), (dp, "model", None, None)),
                      ((b, t // 16 or 1, c.vocab_size), (dp, None, "model"))]
            if c.moe:
                g = 32 if b * t % 32 == 0 else 16
                cap = max(int(c.capacity_factor * (b * t // g) * c.top_k / c.n_experts), 4)
                sites += [((g, b * t // g, c.d_model), (dp, None, None)),
                          ((c.n_experts, g * cap, c.d_model), ("model", dp, None))]
        sites += [((c.d_model, c.n_heads * c.hd), (None, "data")),
                  ((c.vocab_size, c.d_model), ("model", "data"))]
    for s in GNN_SHAPES:
        sites += [((s.n_edges, 128), (("pod", "data", "model"), None)),
                  ((s.n_nodes, 49, 128), (("pod", "data", "model"), None, None)),
                  ((s.n_edges,), (("pod", "data", "model"),))]
    return sites


_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.distributed import constraints as C

    sites, meshes = json.loads(sys.stdin.read())
    seen = []
    def wsc(x, sharding):
        seen.append([list(a) if isinstance(a, tuple) else a for a in sharding.spec])
        return x
    jax.lax.with_sharding_constraint = wsc

    class Arr:
        def __init__(self, shape):
            self.shape, self.ndim = tuple(shape), len(shape)

    out = {}
    for mname, (shape, names) in meshes.items():
        n = int(np.prod(shape))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), tuple(names))
        res = []
        with C.use_mesh(mesh):
            for shp, axes in sites:
                axes = [tuple(a) if isinstance(a, list) else a for a in axes]
                del seen[:]
                C.constrain(Arr(shp), *axes)
                res.append(seen[0] if seen else None)
        out[mname] = res
    print(json.dumps(out))
""")


def test_constrain_fits_as_the_reference():
    sites = _call_sites()
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT], input=json.dumps([sites, MESHES]),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    for mname, (shape, names) in MESHES.items():
        sizes = dict(zip(names, shape))
        for (shp, axes), want in zip(sites, ref[mname]):
            got = tsh.fitted_spec(shp, axes, names, sizes)
            want = None if want is None else tuple(
                tuple(a) if isinstance(a, list) else a for a in want)
            assert got == want, (mname, shp, axes)


def test_constrain_lays_out_dtensors_by_the_fitted_spec():
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    with fake_world(8):
        mesh = make_cpu_mesh((2, 4))
        x = distribute_tensor(torch.zeros(8, 12, 6), mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
        with use_mesh(mesh):
            assert current_mesh() is mesh
            y = constrain(x, ("pod", "data"), "model", None)
            assert isinstance(y, DTensor) and tuple(y.placements) == (Shard(0), Shard(1))
            assert y.to_local().shape == (4, 3, 6)
            z = constrain(x, None, None, "model")  # 6 % 4: nothing fits, no pin
            assert z is x
            w = constrain(x, "data", ("data", "model"), None)  # 2 x 4 does not divide 12
            assert tuple(w.placements) == (Shard(0), Replicate())
        assert current_mesh() is None


def test_constrain_without_a_mesh_returns_its_argument():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert constrain(x, ("pod", "data"), "model", None) is x
    with fake_world(8):
        with use_mesh(make_cpu_mesh((2, 4))):
            assert constrain(x, "data", "model", None) is x  # a plain tensor


def test_make_production_mesh_requires_ranks():
    with pytest.raises(RuntimeError):
        make_production_mesh()  # no process group: 1 rank < 256
    with fake_world(8):
        with pytest.raises(RuntimeError):
            make_production_mesh(multi_pod=True)


# ------------------------------------------------------------- reshard_tree
_SPECS = {"a": ("data", "model"), "b": (("data", "model"), None), "c": (None, "model"),
          "d": (), "e": ("model", None)}

_SLICE_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    specs, shapes = json.loads(sys.stdin.read())
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    out = {}
    for k, spec in specs.items():
        spec = P(*[tuple(a) if isinstance(a, list) else a for a in spec])
        x = jax.device_put(np.zeros(shapes[k], np.float32), NamedSharding(mesh, spec))
        out[k] = {str(s.device.id): [[sl.start or 0, sl.stop if sl.stop is not None else n]
                                    for sl, n in zip(s.index, shapes[k])]
                  for s in x.addressable_shards}
    print(json.dumps(out))
""")


def test_reshard_tree_local_shards_are_jax_slices():
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 12), "b": (16, 3), "c": (5, 8), "d": (3,), "e": (12, 2)}
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _SLICE_SCRIPT],
                       input=json.dumps([_SPECS, shapes]), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    slices = json.loads(r.stdout.strip().splitlines()[-1])
    specs = {k: tsh.P(*v) for k, v in _SPECS.items()}
    for rank in range(8):
        with fake_world(8, rank=rank):
            mesh = make_cpu_mesh((2, 4))
            out = reshard_tree(tree, mesh, specs)
            for k, arr in tree.items():
                sl = tuple(slice(a, b) for a, b in slices[k][str(rank)])
                np.testing.assert_array_equal(out[k].to_local().numpy(), arr[sl])
                assert tuple(out[k].shape) == arr.shape


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import AbstractMesh

    m = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tsh.placements(tsh.P(("pod", "data"), "model"), m) == [Shard(0), Shard(0), Shard(1)]
    assert tsh.placements(tsh.P(), m) == [Replicate()] * 3
    with pytest.raises(ValueError):
        tsh.placements(tsh.P(("data", "pod"), None), m)
    assert tsh.P(("data",), None) == ("data", None)  # one-name entries normalise


def test_all_archs_listed():
    assert set(LMS + GNNS + ["bst"]) == set(list_archs())
