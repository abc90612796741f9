"""The port's mesh collectives against the JAX package's under ``shard_map``.

``pmean_tree``, ``all_to_all_tokens`` (split and concat axes 0 and 1) and
``compressed_psum`` (``int8`` and ``topk``) run on 4 gloo ranks, each a
process on the CPU with its slice of the same seeded inputs (rendezvous
through a ``FileStore`` in the test's temporary directory).  The JAX
package's functions run under ``shard_map`` on 4 forced CPU devices in a
subprocess.  ``all_to_all_tokens`` and the int32 sums of ``compressed_psum``
must be equal exactly; the means and dequantized outputs within f32 atol
1e-6 and rtol 1e-5.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

N = 4
SEED = 7
COMBOS = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _inputs():
    rng = np.random.default_rng(SEED)
    return {
        "tree_a": rng.standard_normal((N, 6, 5)).astype(np.float32),
        "tree_c": rng.standard_normal((N, 7)).astype(np.float32),
        "tok": rng.standard_normal((N, 8, 12)).astype(np.float32),
        "g_w": rng.standard_normal((N, 6, 10)).astype(np.float32),
        "g_b": (rng.standard_normal((N, 10)) * 1e-3).astype(np.float32),
        "r_w": (rng.standard_normal((N, 6, 10)) * 1e-2).astype(np.float32),
        "r_b": (rng.standard_normal((N, 10)) * 1e-5).astype(np.float32),
    }


_REF = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.distributed import collectives as C, compression as Z

    d = dict(np.load(sys.argv[1]))
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("pod",))
    sm = lambda f, n_in, n_out: shard_map(f, mesh, in_specs=(P("pod"),) * n_in,
                                          out_specs=(P("pod"),) * n_out, check_rep=False)
    out = {}
    def pm(a, c):
        t = C.pmean_tree({"a": a[0], "b": {"c": c[0]}}, "pod")
        return t["a"][None], t["b"]["c"][None]
    out["pmean_a"], out["pmean_c"] = sm(pm, 2, 2)(d["tree_a"], d["tree_c"])
    for s, k in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        f = lambda x, s=s, k=k: (C.all_to_all_tokens(x[0], "pod", s, k)[None],)
        out[f"a2a_{s}{k}"] = sm(f, 1, 1)(d["tok"])[0]
    for method in ("int8", "topk"):
        def cp(gw, gb, rw, rb, method=method):
            o, r = Z.compressed_psum({"w": gw[0], "b": gb[0]}, {"w": rw[0], "b": rb[0]},
                                     "pod", method)
            return o["w"][None], o["b"][None], r["w"][None], r["b"][None]
        res = sm(cp, 4, 4)(d["g_w"], d["g_b"], d["r_w"], d["r_b"])
        for name, v in zip(("ow", "ob", "rw", "rb"), res):
            out[f"{method}_{name}"] = v
        if method == "int8":
            def qs(gw, rw):
                c_, _ = Z.apply_error_feedback(gw[0], rw[0], "int8")
                q, s = Z.compress_int8(c_.astype(jnp.float32))
                return (jax.lax.psum(q.astype(jnp.int32), "pod")[None],
                        jax.lax.psum(s, "pod")[None])
            out["qsum"], out["ssum"] = sm(qs, 2, 2)(d["g_w"], d["r_w"])
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""")

_PORT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import collectives as C, compression as Z

    torch.set_num_threads(1)
    rank, store_path, inp, outp = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4), rank=rank,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
        d = {k: torch.as_tensor(v[rank]) for k, v in np.load(inp).items()}
        out = {}
        t = C.pmean_tree({"a": d["tree_a"], "b": {"c": d["tree_c"]}}, mesh, "pod")
        out["pmean_a"], out["pmean_c"] = t["a"], t["b"]["c"]
        for s, k in [(0, 0), (0, 1), (1, 0), (1, 1)]:
            out[f"a2a_{s}{k}"] = C.all_to_all_tokens(d["tok"], mesh, "pod", s, k)
        for method in ("int8", "topk"):
            o, r = Z.compressed_psum({"w": d["g_w"], "b": d["g_b"]},
                                     {"w": d["r_w"], "b": d["r_b"]}, mesh, "pod", method)
            out[f"{method}_ow"], out[f"{method}_ob"] = o["w"], o["b"]
            out[f"{method}_rw"], out[f"{method}_rb"] = r["w"], r["b"]
        c_, _ = Z.apply_error_feedback(d["g_w"], d["r_w"], "int8")
        q, s = Z.compress_int8(c_.to(torch.float32))
        out["qsum"] = C._all_reduce(q.to(torch.int32), "sum", mesh.get_group("pod"))
        out["ssum"] = C._all_reduce(s.reshape(1), "sum", mesh.get_group("pod"))[0]
        np.savez(outp, **{k: v.numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inp = tmp / "inputs.npz"
    np.savez(inp, **_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(inp), str(tmp / "ref.npz")],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _PORT, str(r), str(tmp / "store"), str(inp),
         str(tmp / f"port{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(N)]
    for p in [ref] + ranks:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    want = dict(np.load(tmp / "ref.npz"))
    got = [dict(np.load(tmp / f"port{r}.npz")) for r in range(N)]
    return want, got


def _close(a, b):
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_pmean_tree(results):
    want, got = results
    for r in range(N):
        _close(got[r]["pmean_a"], want["pmean_a"][r])
        _close(got[r]["pmean_c"], want["pmean_c"][r])


@pytest.mark.parametrize("split,concat", COMBOS)
def test_all_to_all_tokens_exact(results, split, concat):
    want, got = results
    w = want[f"a2a_{split}{concat}"]  # each rank's block on a new leading axis
    for r in range(N):
        np.testing.assert_array_equal(got[r][f"a2a_{split}{concat}"], w[r])


def test_compressed_psum_int8_sums_exact(results):
    want, got = results
    for r in range(N):
        np.testing.assert_array_equal(got[r]["qsum"], want["qsum"][r])
        assert got[r]["qsum"].dtype == np.int32
        np.testing.assert_array_equal(got[r]["ssum"], want["ssum"][r])


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compressed_psum_outputs(results, method):
    want, got = results
    for r in range(N):
        for name in ("ow", "ob", "rw", "rb"):
            _close(got[r][f"{method}_{name}"], want[f"{method}_{name}"][r])
