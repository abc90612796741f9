"""The reference against the port on the CPU: its placement and its router
agree with the store's, and a whole small run of each cell comes out
correct."""
import numpy as np
import pytest

from geobench.harness import build_store, run_cell
from geobench.inputs import make_inputs
from geobench.reference.placement import layered_graph, place
from geobench.reference.route import layer_components, route_one


def test_router_agrees_with_the_store(cell_of):
    from repro_torch.core.routing import route_online, route_online_batch

    cell = cell_of(flat=True)
    inputs = make_inputs(cell.config, 17)
    store = build_store(cell.config, inputs, "cpu")
    g, env = inputs.g, inputs.env
    comp = layer_components(env.rtt_s, g.partition, g.src, g.dst)
    np.testing.assert_array_equal(
        comp[1:] == comp[1:, :1], store.lg.comp_of_dc[1:] == store.lg.comp_of_dc[1:, :1])
    reqs = [(p.items, o) for p in inputs.patterns for o in range(env.n_dcs) if len(p.items)]
    batch = route_online_batch(store.lg, store.state, reqs, device="cpu")
    for (items, o), got in zip(reqs, batch):
        served, dcs, lat = route_one(items, o, store.state.delta, comp, g.item_size(),
                                     env.rtt_s, env.bw_Bps)
        np.testing.assert_array_equal(got.served_by, served)
        np.testing.assert_array_equal(got.dcs, dcs)
        assert got.latency_s == pytest.approx(lat.max(), rel=1e-12)
        alone = route_online(store.lg, store.state, items, o)
        _, _, lat1 = route_one(items, o, store.state.delta, comp, g.item_size(),
                               env.rtt_s, env.bw_Bps, lone=True)
        assert alone.latency_s == lat1.max()


@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12])
def test_placement_agrees_with_the_store(cell_of, seed):
    cell = cell_of(flat=True)
    cell.config["graph"].update(n_nodes=2500, n_communities=4, mean_degree=30.0)
    cell.config["patterns"].update(n_patterns=120, n_hot_sources=48)
    cell.config["store"].pop("placement_device")  # the store's own build, with its stats
    inputs = make_inputs(cell.config, seed)
    store = build_store(cell.config, inputs, "cpu")
    L = layered_graph(inputs.g, inputs.env)
    np.testing.assert_array_equal(L.comp, store.lg.comp_of_dc)
    assert [[(b.bid, b.comp, b.children, b.dcs.tolist()) for b in layer]
            for layer in L.bridges] == [
        [(b.bs_id, b.comp, b.children, b.dcs.tolist()) for b in layer]
        for layer in store.lg.layers]
    stats = store.stats.placement_stats
    assert stats["replicated"] > 0 and stats["decomposed"] > 0
    delta = place(inputs.g, inputs.env, inputs.patterns)
    assert delta.sum() > inputs.g.n_items  # replicas beyond the owners' copies
    np.testing.assert_array_equal(delta, store.state.delta)


@pytest.mark.parametrize("flat", [False, True])
def test_small_run_is_correct(cell_of, flat):
    out = run_cell(cell_of(flat=flat), 2**31 + 5, 1.5, trace=not flat, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 400 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
