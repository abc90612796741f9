"""The ragged route expansion on the CPU: its plain version, its packing
and the router's item gate.

* ``ref.route_expand_ragged_ref`` on one flat batch mixing reads of 0, 1,
  31-33, 256-257, 25,824, 25,825 and 40,000 items over seeded random
  replica sets: the same picks and layers as the numpy router's
  ``_expand_numpy`` and as the benchmark's reference router
  (``geobench/reference/route.py``), and its exact int64 sums the
  reference's bytes, serving DCs and (Eq. 1 over them) latencies;
* ``pack_ragged`` / ``unpack_ragged`` (item ids, offsets, origins, block
  order), ``ragged_order`` and ``ragged_buffers``, the one-copy layouts the
  card's call uses, and the id-keyed plain version over the tables;
* the item gate, over a store's route tables: a sub-batch of 50 reads of
  about 3k items takes the fused path, a lone read the scalar router, two
  short reads the numpy router.
"""
import types

import numpy as np
import pytest
import torch

from geobench.reference.route import route_one
from repro_torch.core.graph import Graph
from repro_torch.core.latency import make_paper_env
from repro_torch.core.layered_graph import build_layered_graph
from repro_torch.core import routing
from repro_torch.core.route_tables import _bit_pack, fold_shift
from repro_torch.core.routing import _expand_numpy, route_online_batch
from repro_torch.kernels import ops
from repro_torch.kernels.ref import route_expand_ragged_ids_ref, route_expand_ragged_ref
from repro_torch.kernels.route_expand import (
    WARP_SHARE,
    pack_ragged,
    ragged_buffers,
    ragged_order,
    unpack_ragged,
)
from repro_torch.obs import MetricsRegistry, Tracer

LENS = (0, 1, 31, 32, 33, 256, 257, 25_824, 25_825, 40_000)
N_ITEMS = 60_000


def _comp(rng, D: int, L: int) -> np.ndarray:
    """``[L + 1, D]`` nested layer components, layer 0 each DC alone."""
    comp = np.zeros((L + 1, D), np.int64)
    comp[0] = np.arange(D)
    for layer in range(1, L + 1):
        groups = max(1, D // (layer + 1))
        comp[layer] = rng.integers(0, groups, int(comp[layer - 1].max()) + 1)[comp[layer - 1]]
    return comp


def _batch(seed: int, D: int, L: int, one_origin: bool):
    rng = np.random.default_rng(seed)
    delta = rng.random((N_ITEMS, D)) < 0.3
    requests = [(rng.integers(0, N_ITEMS, n), 0 if one_origin else int(rng.integers(0, D)))
                for n in LENS]
    sizes = (rng.random(N_ITEMS) * 200 + 16).astype(np.float32)
    rtt = rng.random((D, D)) * 0.2
    rtt = rtt + rtt.T
    np.fill_diagonal(rtt, 0.0)
    bw = rng.random((D, D)) * 1e8 + 1e7
    np.fill_diagonal(bw, np.inf)
    return requests, delta, _comp(rng, D, L), sizes, rtt, bw


def _flat(requests, delta, sizes):
    items = np.concatenate([it for it, _ in requests]).astype(np.int64)
    bounds = np.concatenate([[0], np.cumsum([len(it) for it, _ in requests])])
    origin = np.array([o for _, o in requests], np.int64)
    return items, bounds, origin, _bit_pack(delta[items]), sizes[items]


def _t(x, dtype):
    return torch.as_tensor(np.ascontiguousarray(x)).to(dtype)


@pytest.mark.parametrize("D,L,one_origin", [(5, 3, False), (5, 3, True), (12, 4, False)],
                         ids=["mixed origins", "one origin", "12 DCs"])
def test_ragged_plain_version_matches_the_routers(D, L, one_origin):
    requests, delta, comp, sizes, rtt, bw = _batch(31 + D + one_origin, D, L, one_origin)
    items, bounds, origin, bits, sz = _flat(requests, delta, sizes)
    shift = fold_shift(sizes)
    args = (_t(bits, torch.int32), _t(sz, torch.float32), _t(bounds, torch.int32),
            _t(origin, torch.int32), _t(comp, torch.int32), shift)
    served, units, layers, miss, served_dcs, n_miss = route_expand_ragged_ref(*args)
    assert served.dtype == torch.int8 and served.shape == (len(items),)
    assert units.dtype == torch.int64 and units.shape == (len(requests), D)

    req_id = np.repeat(np.arange(len(requests)), np.diff(bounds))
    lg = types.SimpleNamespace(comp_of_dc=comp, n_layers=L)
    want_served, want_layers = _expand_numpy(lg, delta[items], req_id, origin,
                                             MetricsRegistry(), False)
    np.testing.assert_array_equal(served.numpy(), want_served)
    np.testing.assert_array_equal(layers.numpy(), want_layers)

    # the benchmark's own router, written apart from the port: its f64 sums
    # are the exact int64 sums' bytes, bit for bit
    bytes_rd = np.ldexp(units.numpy().astype(np.float64), -shift)
    for r, (it, o) in enumerate(requests):
        ref_served, dcs, lat = route_one(it, o, delta, comp, sizes, rtt, bw)
        np.testing.assert_array_equal(served[bounds[r]:bounds[r + 1]].numpy(), ref_served)
        assert int(served_dcs[r]) == sum(1 << int(d) for d in dcs)
        assert int(n_miss[r]) == (ref_served < 0).sum()
        at = ref_served >= 0
        want_bytes = np.bincount(ref_served[at], weights=sizes[it][at], minlength=D)
        np.testing.assert_array_equal(bytes_rd[r], want_bytes)
        got_lat = [0.0 if d == o else rtt[d, o] + bytes_rd[r, d] / bw[d, o] for d in dcs]
        np.testing.assert_array_equal(got_lat, lat)


def test_ragged_packing_round_trips_and_orders_long_reads_first():
    requests, delta, comp, sizes, _, _ = _batch(5, 5, 3, False)
    items, bounds, origin, bits, sz = _flat(requests, delta, sizes)
    lens = np.diff(bounds)
    order, n_long = ragged_order(lens)
    assert n_long == int((lens > WARP_SHARE).sum()) == 4
    assert sorted(order.tolist()) == list(range(len(lens)))
    assert (lens[order[:n_long]] > WARP_SHARE).all()
    assert (lens[order[n_long:]] <= WARP_SHARE).all()

    buf, n = pack_ragged(items, bounds, origin)
    assert n == n_long and buf.dtype == np.int32 and len(buf) == len(items) + 3 * len(origin) + 1
    i, off, org, ordr = unpack_ragged(torch.from_numpy(buf), len(items), len(origin))
    np.testing.assert_array_equal(i.numpy(), items)
    np.testing.assert_array_equal(off.numpy(), bounds)
    np.testing.assert_array_equal(org.numpy(), origin)
    np.testing.assert_array_equal(ordr.numpy(), order)

    # the unpacked views route over the tables as the gathered rows do, and
    # ops takes the ids over the tables on the CPU
    comp_t, shift = _t(comp, torch.int32), fold_shift(sizes)
    want = route_expand_ragged_ref(_t(bits, torch.int32), _t(sz, torch.float32), off, org,
                                   comp_t, shift)
    tables = (_t(_bit_pack(delta), torch.int32), _t(sizes, torch.float32))
    got = route_expand_ragged_ids_ref(i, *tables, off, org, comp_t, shift)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    served, layers, miss, units, served_dcs, n_miss = ops.route_expand_flat_ids(
        items, bounds, origin, tables, comp_t, device="cpu", shift=shift)
    for a, b in zip((served, units, layers, miss, served_dcs, n_miss), want):
        np.testing.assert_array_equal(a, b.numpy())


def test_ragged_buffers_are_disjoint_views():
    """Every output is a view of one int32 buffer, read back in one copy;
    the int64 sums lie first, on its aligned start."""
    N, R, D, L = 11, 3, 5, 2
    ints, served, units, layers, miss, served_dcs, n_miss = ragged_buffers(N, R, D, L, "cpu")
    assert (served.shape, units.shape, layers.shape, miss.shape) == (
        (N,), (R, D), (R,), (R, L + 1))
    assert served_dcs.shape == n_miss.shape == (R,) and units.dtype == torch.int64
    served.fill_(-1)
    units.fill_(-(1 << 40))
    layers.fill_(7)
    miss.fill_(9)
    served_dcs.fill_(11)
    n_miss.fill_(13)
    host = ints.numpy()
    u = 2 * R * D
    np.testing.assert_array_equal(host[:u].view(np.int64), -(1 << 40))
    np.testing.assert_array_equal(host[u:u + R], 7)
    np.testing.assert_array_equal(host[u + R:u + R * (L + 2)], 9)
    np.testing.assert_array_equal(host[u + R * (L + 2):u + R * (L + 3)], 11)
    np.testing.assert_array_equal(host[u + R * (L + 3):u + R * (L + 4)], 13)
    np.testing.assert_array_equal(host[u + R * (L + 4):].view(np.int8)[:N], -1)


def _gate_store():
    env = make_paper_env()
    rng = np.random.default_rng(17)
    n = 2000
    src, dst = rng.integers(0, n, 9000), rng.integers(0, n, 9000)
    keep = src != dst
    g = Graph.from_edges(n, src[keep], dst[keep], partition=rng.integers(0, env.n_dcs, n))
    lg = build_layered_graph(g, env)
    state = types.SimpleNamespace(delta=rng.random((g.n_items, env.n_dcs)) < 0.3)
    state.delta[np.arange(g.n_items), rng.integers(0, env.n_dcs, g.n_items)] = True
    sizes = g.item_size()
    tables = (torch.as_tensor(_bit_pack(state.delta)), torch.as_tensor(sizes, dtype=torch.float32))
    return lg, state, rng, sizes, tables


@pytest.mark.parametrize("reads,items,path", [(50, 3000, "fused"), (1, 3000, "scalar"),
                                              (2, 10, "numpy")],
                         ids=["50 reads of about 3k items", "a lone read", "two short reads"])
def test_item_gate_picks_the_path(reads, items, path):
    lg, state, rng, sizes, tables = _gate_store()
    jitter = items // 20
    requests = [(np.sort(rng.choice(lg.g.n_items, items + int(rng.integers(-jitter, jitter + 1)),
                                    replace=False)), int(rng.integers(0, 5)))
                for _ in range(reads)]
    tracer = Tracer(enabled=True)
    got = route_online_batch(lg, state, requests, sizes=sizes, device="cpu", tracer=tracer,
                             tables=tables)
    (expand,) = [r for r in tracer.records if r.name == "route.expand"]
    n_items = sum(len(it) for it, _ in requests)
    assert expand.tags == {"path": path, "reads": reads, "items": n_items}
    if reads > 1:
        assert (n_items >= routing.FUSED_MIN_ITEMS) == (path == "fused")
    want = route_online_batch(lg, state, requests, fast=False, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.served_by, b.served_by)
        assert a.latency_s == b.latency_s and a.layers_used == b.layers_used
