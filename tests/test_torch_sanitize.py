"""The port's runtime sanitizer against the JAX package's, on the CPU.

Twin stores (one per package, built from the same seeded inputs, the port's
with ``device="cpu"``) pass every check when clean, and each planted fault
— route-index drift, a forked demand layer, a copied heat row, a re-keyed
journal, unsorted or out-of-range journal rows, a metrics type clash —
fails both with the same message.  A stale row of the port's route tables
fails the port's own check.  Attaching, the check cadence and the
``REPRO_SANITIZE`` switch behave the same.
"""
import types

import numpy as np
import pytest

from repro.core.graph import build_csr as j_build_csr
from repro.core.latency import make_paper_env as j_paper_env
from repro.core.patterns import Workload as JWorkload
from repro.core.patterns import generate_khop_patterns as j_khop
from repro.core.placement import PlacementConfig as JPlacementConfig
from repro.core.store import GeoGraphStore as JStore
from repro.data.synthetic import community_graph as j_community
from repro.debug import sanitize as jsan
from repro.demand import ODDemandLayer as JODDemandLayer
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro_torch.core.graph import build_csr
from repro_torch.core.latency import make_paper_env
from repro_torch.core.patterns import Workload, generate_khop_patterns
from repro_torch.core.placement import PlacementConfig
from repro_torch.core.store import GeoGraphStore
from repro_torch.data.synthetic import community_graph
from repro_torch.debug import sanitize as tsan
from repro_torch.demand import ODDemandLayer
from repro_torch.obs.metrics import MetricsRegistry

PORT = dict(Store=GeoGraphStore, community=community_graph, csr=build_csr,
            env=make_paper_env, khop=generate_khop_patterns, Workload=Workload,
            Config=PlacementConfig, Demand=ODDemandLayer, Registry=MetricsRegistry,
            san=tsan, kw=dict(device="cpu"))
JAX = dict(Store=JStore, community=j_community, csr=j_build_csr, env=j_paper_env,
           khop=j_khop, Workload=JWorkload, Config=JPlacementConfig, Demand=JODDemandLayer,
           Registry=JRegistry, san=jsan, kw={})


def _store(pkg, seed=0):
    g = pkg["community"](400, n_communities=8, p_in=0.04, p_out=0.001, seed=seed, n_dcs=5)
    env = pkg["env"]()
    csr = pkg["csr"](g.n_nodes, g.src, g.dst, symmetrize=True)
    pats = pkg["khop"](g, csr, 24, seed=seed + 1, n_dcs=env.n_dcs)
    wl = pkg["Workload"].from_patterns(pats, g.n_items, env.n_dcs)
    return pkg["Store"](g, env, wl, config=pkg["Config"](precache=False, dhd_steps=4),
                        demand_window_s=6.0, **pkg["kw"])


@pytest.fixture(scope="module")
def twins():
    return [(pkg, _store(pkg)) for pkg in (PORT, JAX)]


def _message(pkg, store):
    """The sanitizer's failure text on ``store`` (None when clean)."""
    try:
        pkg["san"].StoreSanitizer(store).check()
    except pkg["san"].SanitizerError as e:
        return str(e)
    return None


def test_twin_stores_match(twins):
    (_, port), (_, ref) = twins
    assert np.array_equal(port.state.delta, ref.state.delta)
    assert np.array_equal(port.state.route, ref.state.route)


def test_clean_stores_pass_in_both(twins):
    for pkg, store in twins:
        s = pkg["san"].StoreSanitizer(store)
        assert s.check() is True and s.checks_run == 1


def _route_drift(pkg, store):
    idx = store.route_index
    old = int(idx.nearest[0, 0])
    idx.nearest[0, 0] = (old + 1) % store.env.n_dcs

    def undo():
        idx.nearest[0, 0] = old
    return undo


def _forked_demand(pkg, store):
    cache = store.caches[next(iter(store.caches))]
    orig = cache.demand
    cache.demand = pkg["Demand"](store.g.n_items, 1)

    def undo():
        cache.demand = orig
    return undo


def _copied_heat_row(pkg, store):
    """A cache on the store's demand layer whose heat row is a copy."""
    dc = next(iter(store.caches))
    orig = store.caches[dc]
    store.caches[dc] = types.SimpleNamespace(demand=store.demand,
                                             heat=store.demand.heat[dc].copy())

    def undo():
        store.caches[dc] = orig
    return undo


def _journal_uid_copy(pkg, store):
    journal = store._placement_journal
    orig = journal.item_uid
    journal.item_uid = store._item_uid.copy()

    def undo():
        journal.item_uid = orig
    return undo


def _journal_rows(pkg, store, bad):
    journal = store._placement_journal
    regions = next(r for r in journal.regions.values() if any(len(x.items) > 1 for x in r))
    reg = next(x for x in regions if len(x.items) > 1)
    orig = reg.items
    reg.items = bad(np.asarray(orig), store)

    def undo():
        reg.items = orig
    return undo


def _journal_unsorted(pkg, store):
    return _journal_rows(pkg, store, lambda it, s: it[::-1].copy())


def _journal_out_of_range(pkg, store):
    return _journal_rows(pkg, store, lambda it, s: np.append(it, s.g.n_items))


def _metrics_clash(pkg, store):
    r1, r2 = pkg["Registry"](enabled=True), pkg["Registry"](enabled=True)
    r1.counter("sanitize.clash").inc()
    r2.histogram("sanitize.clash").observe(1.0)
    store.shard_registries = [r1, r2]

    def undo():
        del store.shard_registries
    return undo


FAULTS = {
    "route-index divergence": _route_drift,
    "heat aliasing: cache[0] holds a different demand": _forked_demand,
    "heat aliasing: cache[0].heat is not a view": _copied_heat_row,
    "journal digest: journal.item_uid": _journal_uid_copy,
    "journal digest: memoized region rows unsorted": _journal_unsorted,
    "journal digest: memoized region rows out of range": _journal_out_of_range,
    "metrics merge": _metrics_clash,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_gives_the_same_failure(twins, fault):
    messages = []
    for pkg, store in twins:
        undo = FAULTS[fault](pkg, store)
        try:
            messages.append(_message(pkg, store))
        finally:
            undo()
        assert _message(pkg, store) is None  # restored: clean again
    assert messages[0] is not None and fault in messages[0]
    assert messages[0] == messages[1]


def test_planted_stale_route_table_row_fails_the_port():
    """The port's own check, which the JAX package has no tables for: one
    row of the bitmask table left stale while the placement changed (the
    patch event missed) fails with its message, and the rows patched
    through the index pass again."""
    store = _store(PORT, seed=5)
    store.route_tables.add_device("cpu")  # a store keeps sets on its cards alone
    san = tsan.StoreSanitizer(store)
    assert san.check() is True
    row = int(np.flatnonzero(store.state.delta.sum(axis=1) >= 2)[0])
    dc = int(np.flatnonzero(store.state.delta[row])[-1])
    store.state.delta[row, dc] = False  # no event: the tables keep the old row
    with pytest.raises(tsan.SanitizerError, match="route-table divergence: replica bitmasks"):
        san.check()
    store.route_index.patch_rows(store.state.delta, np.array([row]))
    assert san.check() is True


@pytest.mark.parametrize("where", ["host", "device set"])
def test_planted_stale_byte_scale_fails_the_port(where):
    """A byte scale left stale (a byte change that did not re-derive it),
    on the host tables or on a device set, fails with its message."""
    store = _store(PORT, seed=5)
    store.route_tables.add_device("cpu")
    rt = store.route_tables
    san = tsan.StoreSanitizer(store)
    assert san.check() is True and rt.shift is not None
    shift = rt.shift
    (dev,) = rt.device_tables
    if where == "host":
        rt.shift = shift + 1
    else:
        rt.device_tables[dev] = rt.device_tables[dev]._replace(shift=None)
    with pytest.raises(tsan.SanitizerError, match="route-table divergence: byte scale"):
        san.check()
    rt.shift = shift
    rt.device_tables[dev] = rt.device_tables[dev]._replace(shift=shift)
    assert san.check() is True


# -------------------------------------------------------- attach & cadence
def _dummy_store():
    calls = []
    store = types.SimpleNamespace(calls=calls)
    store.apply_updates = lambda *a, **k: calls.append(("apply_updates", a))
    store.compact = lambda *a, **k: calls.append(("compact", a))
    return store


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
def test_attach_cadence_and_idempotence(pkg):
    store = _dummy_store()
    s = pkg["san"].attach_sanitizer(store, every=2)
    wrapped = store.apply_updates
    assert pkg["san"].attach_sanitizer(store) is s and store.apply_updates is wrapped
    store.apply_updates(1)
    assert (s.ops_seen, s.checks_run) == (1, 0)
    store.compact()
    assert (s.ops_seen, s.checks_run) == (2, 1)
    assert store.calls == [("apply_updates", (1,)), ("compact", ())]


@pytest.mark.parametrize("value,enabled", [(None, False), ("0", False), ("no", False),
                                           ("1", True), ("yes", True)])
def test_env_switch_matches(monkeypatch, value, enabled):
    if value is None:
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    else:
        monkeypatch.setenv("REPRO_SANITIZE", value)
    for pkg in (PORT, JAX):
        assert pkg["san"].sanitize_enabled() is enabled
        assert (pkg["san"].maybe_attach(_dummy_store()) is not None) is enabled


def test_wrapped_real_stores_check_after_ops():
    """Both packages' wrapped mutators run checks that pass through serving
    and maintenance, and leave the twins equal."""
    port, ref = _store(PORT, seed=3), _store(JAX, seed=3)
    sans = [PORT["san"].attach_sanitizer(port, every=1),
            JAX["san"].attach_sanitizer(ref, every=1)]
    pats = [p for p in ref.workload.patterns if len(p.items)][:6]
    for store in (port, ref):
        store.serve_batch([(p.items, i % 5) for i, p in enumerate(pats)])
        store.maintain()
    assert [s.checks_run for s in sans] == [1, 1]
    assert np.array_equal(port.state.delta, ref.state.delta)
