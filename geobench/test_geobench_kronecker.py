"""The Kronecker graph a configuration may name (``"generator": "kronecker"``):
Graph500's generator drawn as specified, relabelled by ``--seed`` like the
knows graph, walked along a direction from starts of a least degree, and
a small deployment on it served and checked through ``run_cell`` on the
CPU, with a planted fault caught."""
import copy

import numpy as np
import pytest

from geobench.harness import resolve_cell, run_cell
from geobench.inputs import khop_patterns, knows_graph, kronecker_graph, make_inputs
from geobench.traffic import make_writes

GRAPH500 = dict(generator="kronecker", scale=10, edge_factor=16, a=0.57, b=0.19, c=0.19,
                node_bytes=256.0, edge_bytes=64.0, base_seed=3)
PATTERNS = dict(n_patterns=24, hop_weights=[5, 6], branch=1 << 30, n_hot_sources=8,
                base_seed=1, direction="out", start_min_degree=1)


def _config(**graph):
    return {"graph": dict(GRAPH500, **graph), "patterns": dict(PATTERNS)}


def _degrees(g):
    out = np.bincount(g.src, minlength=g.n_nodes)
    return out, np.bincount(g.dst, minlength=g.n_nodes)


def test_graph_has_two_to_the_scale_vertices_and_no_loop_or_repeated_pair():
    g, wiring = kronecker_graph(GRAPH500, 5)
    assert wiring is None
    assert g.n_nodes == 1 << GRAPH500["scale"]
    # at scale 10 about a quarter of the draws repeat a pair
    assert 0.6 * 16 * g.n_nodes < g.n_edges <= 16 * g.n_nodes
    assert (g.src != g.dst).all()
    key = g.src.astype(np.int64) * g.n_nodes + g.dst
    assert (np.diff(key) > 0).all()  # sorted by (source, destination), each pair once
    assert len(g.node_size) == g.n_nodes and len(g.edge_size) == g.n_edges
    assert set(np.unique(g.partition).tolist()) == set(range(5))
    assert 200.0 < np.median(g.node_size) < 330.0 and 50.0 < np.median(g.edge_size) < 82.0


def test_graph_repeats_by_base_seed_and_spreads_home_dcs_evenly():
    a, _ = kronecker_graph(GRAPH500, 5)
    b, _ = kronecker_graph(GRAPH500, 5)
    for f in ("src", "dst", "node_size", "edge_size", "partition"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    c, _ = kronecker_graph(dict(GRAPH500, base_seed=4), 5)
    assert a.n_edges != c.n_edges or not np.array_equal(a.src, c.src)
    d, _ = kronecker_graph(dict(GRAPH500, scale=12), 5)
    shares = np.bincount(d.partition, minlength=5) / d.n_nodes
    assert np.all(np.abs(shares - 0.2) < 0.02), shares


def test_initiator_sets_the_skew_of_each_side():
    # a uniform initiator is an Erdos-Renyi graph; Graph500's is heavy-tailed,
    # more than the knows graph at the same size; the row bit follows a + b
    # and the column bit a + c, so an initiator heavier in its rows skews the
    # out-degrees more than the in-degrees
    def skew(d):
        return d.max() / d.mean()

    uniform, _ = kronecker_graph(dict(GRAPH500, scale=12, a=0.25, b=0.25, c=0.25), 5)
    assert skew(sum(_degrees(uniform))) < 2.5
    kron, _ = kronecker_graph(dict(GRAPH500, scale=12), 5)
    knows, _ = knows_graph(dict(resolve_cell("snb3s-nbr-over").config["graph"],
                                n_nodes=1 << 12), 5)
    assert skew(sum(_degrees(kron))) > 3 * skew(sum(_degrees(knows)))
    rows, _ = kronecker_graph(dict(GRAPH500, scale=12, a=0.7, b=0.2, c=0.05), 5)
    out, inn = _degrees(rows)
    assert skew(out) > 2 * skew(inn)


def test_seed_relabels_and_keeps_the_degrees():
    a = make_inputs(_config(), 2**31 + 101)
    b = make_inputs(_config(), 2**31 + 102)
    assert a.wiring is None and b.wiring is None
    assert not np.array_equal(a.g.src, b.g.src)
    for da, db in zip(_degrees(a.g), _degrees(b.g)):
        np.testing.assert_array_equal(np.sort(da), np.sort(db))
    np.testing.assert_array_equal(np.sort(a.g.edge_size), np.sort(b.g.edge_size))
    assert [len(p.items) for p in a.patterns] == [len(p.items) for p in b.patterns]


def _neighbourhood(g, start, hops, both: bool):
    reached, frontier, edges = {start}, {start}, set()
    for _ in range(hops):
        fwd = np.isin(g.src, list(frontier))
        bwd = np.isin(g.dst, list(frontier)) if both else np.zeros_like(fwd)
        edges |= set(np.flatnonzero(fwd | bwd).tolist())
        frontier = (set(g.dst[fwd].tolist()) | set(g.src[bwd].tolist())) - reached
        reached |= frontier
    return np.union1d(sorted(reached), g.n_nodes + np.array(sorted(edges), np.int64))


@pytest.mark.parametrize("direction", ["out", "both"])
def test_walk_takes_only_the_named_direction(direction):
    g, _ = kronecker_graph(GRAPH500, 5)
    pats = khop_patterns(g, dict(PATTERNS, direction=direction), 5)
    assert {p.hops for p in pats} == {1, 2}
    for p in pats:  # every edge taken (branch over every degree), along the named ways
        np.testing.assert_array_equal(
            p.items, _neighbourhood(g, p.start, p.hops, both=direction == "both"))


def test_start_min_degree_keeps_isolated_vertices_out_of_the_hot_core():
    g, _ = kronecker_graph(GRAPH500, 5)
    out, _ = _degrees(g)
    assert np.mean(out == 0) > 0.2  # Graph500's graph leaves many without a follow
    pc = dict(PATTERNS, n_patterns=200, n_hot_sources=64)
    every = khop_patterns(g, dict(pc, start_min_degree=0), 5)
    assert min(out[p.start] for p in every) == 0
    for least in (1, 8):
        starts = [p.start for p in khop_patterns(g, dict(pc, start_min_degree=least), 5)]
        assert min(out[starts]) >= least
        assert len(set(starts)) > 10


def test_unknown_generator_or_direction_is_refused():
    with pytest.raises(ValueError, match="generator"):
        make_inputs(_config(generator="lfr"), 1)
    g, _ = kronecker_graph(GRAPH500, 5)
    with pytest.raises(ValueError, match="direction"):
        khop_patterns(g, dict(PATTERNS, direction="in"), 5)


def test_writes_are_refused_on_a_graph_without_wiring():
    inputs = make_inputs(_config(), 2**31 + 103)
    writes = {"rate_ops": 60.0, "arrivals": "poisson", "kind_shares": {"IU1": 1, "IU8": 20},
              "seal_s": 1.0, "warmup_batches": 2}
    with pytest.raises(ValueError, match="kronecker"):
        make_writes(writes, _config()["graph"], inputs.g, inputs.wiring, 5,
                    2**31 + 103, 1.0)


def test_writes_are_refused_beside_reads_walked_one_way(cell_of):
    cell = cell_of("snb3s-nbr-sat")
    cell.config["patterns"]["direction"] = "out"
    cell.mix["writes"] = {"rate_ops": 60.0, "arrivals": "poisson",
                          "kind_shares": {"IU1": 1, "IU8": 20}, "seal_s": 1.0,
                          "warmup_batches": 2}
    with pytest.raises(ValueError, match="both ways"):
        run_cell(cell, 2**31 + 105, 1.0, trace=False, device="cpu")


def _small_cell():
    """``snb3s-nbr-over``'s store and mix over a scale-10 Kronecker graph
    with whole 1-/2-hop out-neighbourhood reads."""
    cell = copy.deepcopy(resolve_cell("snb3s-nbr-over"))
    cell.config.update(_config())
    cell.mix["reads"]["rate_rps"] = 300.0
    cell.mix["warmup_drains"] = [64, 8, 1]
    cell.mix["max_outstanding"] = 64
    return cell


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "payload row changed"])
def test_small_kronecker_run_is_correct_and_a_planted_fault_is_caught(monkeypatch, fault):
    if fault:
        from repro_torch.distributed import sharded_store

        real = sharded_store.payload_for_uids

        def one_changed(uids, width=sharded_store.PAYLOAD_WIDTH):
            rows = real(uids, width)
            rows[len(rows) // 3] += np.float32(0.25)
            return rows

        monkeypatch.setattr(sharded_store, "payload_for_uids", one_changed)
    out = run_cell(_small_cell(), 2**31 + 104, 1.0, trace=False, device="cpu")
    assert out["attempted"] > 200 and out["failed"] == 0
    values = {k: c["value"] for k, c in out["checks"].items()}
    if not fault:
        assert out["correct"], out["checks"]
        assert values == {"replica_rows_differing": 0, "served_by_mismatches": 0,
                          "latency_rel_gap": 0.0, "payload_rows_differing": 0,
                          "unanswered": 0}
        return
    assert not out["correct"]
    assert values.pop("payload_rows_differing") > 0
    assert all(v == 0 for v in values.values()), values
