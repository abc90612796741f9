"""The small host modules of slice A: the port vs the JAX package on the CPU.

* ``core.optimal``: ``solve_exact_tiny`` and ``solve_coordinate_descent``
  give the same replica sets, routes and cost;
* ``demand.forecast``: every forecaster gives the same forecast on seeded
  intensity histories, and ``ODDemandLayer.forecast`` the same demand view;
* ``obs.export``: ``export_chrome_trace`` and ``text_dashboard`` give
  byte-identical output for the same recorded spans and registry;
* ``configs.geolayer``: ``CONFIG.placement_config()`` equals the JAX one
  field by field.
"""
import dataclasses

import numpy as np
import pytest

import repro.configs.geolayer as jax_geolayer
import repro.demand as jax_demand
import repro.obs as jax_obs
from repro.core import optimal as jax_optimal
from repro.core.latency import make_paper_env as jax_paper_env
from repro.core.patterns import Pattern as JaxPattern
from repro.core.patterns import Workload as JaxWorkload
import repro_torch.configs.geolayer as geolayer
import repro_torch.demand as demand
import repro_torch.obs as obs
from repro_torch.core import optimal
from repro_torch.core.latency import make_paper_env
from repro_torch.core.patterns import Pattern, Workload


# items of each pattern, by instance size: 3 items (enumerated with up to 2
# extra replicas each), 4 (the JAX package's own tiny instance) and 5
TINY = {
    3: ([0, 1], [2]),
    4: ([0, 1], [2, 3]),
    5: ([0, 1], [2, 3], [1, 4]),
}


def _tiny(pkg_pattern, pkg_workload, env, n_items):
    D = env.n_dcs
    rates = (
        (np.eye(D)[1] * 50, np.zeros(D)),
        (np.eye(D)[3] * 30, np.eye(D)[3] * 2),
        (np.eye(D)[4] * 20 + 1.0, np.eye(D)[0] * 0.5),
    )
    pats = [pkg_pattern(i, np.array(items), r_py=r, w_py=w)
            for i, (items, (r, w)) in enumerate(zip(TINY[n_items], rates))]
    wl = pkg_workload.from_patterns(pats, n_items, D)
    sizes = np.full(n_items, 100.0, np.float32)
    primary = np.array([0, 0, 2, 2, 1])[:n_items]
    return wl, sizes, primary


def _both(n_items):
    env, jenv = make_paper_env(), jax_paper_env()
    return (env, *_tiny(Pattern, Workload, env, n_items)), (jenv, *_tiny(
        JaxPattern, JaxWorkload, jenv, n_items))


@pytest.mark.parametrize("n_items,extra", [(3, 2), (4, 1), (5, 1)])
def test_solve_exact_tiny_matches_jax(n_items, extra):
    (env, wl, sizes, primary), (jenv, jwl, _, _) = _both(n_items)
    state, cost = optimal.solve_exact_tiny(wl, env, sizes, primary, max_enum_items=5,
                                           max_extra_replicas=extra)
    jstate, jcost = jax_optimal.solve_exact_tiny(jwl, jenv, sizes, primary, max_enum_items=5,
                                                 max_extra_replicas=extra)
    assert cost == jcost
    np.testing.assert_array_equal(state.delta, jstate.delta)
    np.testing.assert_array_equal(state.route, jstate.route)


def test_solve_exact_tiny_refuses_what_jax_refuses():
    (env, wl, sizes, primary), (jenv, jwl, _, _) = _both(5)
    for solve, args in ((optimal.solve_exact_tiny, (wl, env)),
                        (jax_optimal.solve_exact_tiny, (jwl, jenv))):
        with pytest.raises(ValueError, match="coordinate descent"):
            solve(*args, sizes, primary, max_enum_items=3)


@pytest.mark.parametrize("n_items,seed,rounds", [(4, 0, 3), (5, 1, 6), (5, 7, 1)])
def test_solve_coordinate_descent_matches_jax(n_items, seed, rounds):
    (env, wl, sizes, primary), (jenv, jwl, _, _) = _both(n_items)
    state, cost = optimal.solve_coordinate_descent(wl, env, sizes, primary,
                                                   max_rounds=rounds, seed=seed)
    jstate, jcost = jax_optimal.solve_coordinate_descent(jwl, jenv, sizes, primary,
                                                         max_rounds=rounds, seed=seed)
    assert cost == jcost
    np.testing.assert_array_equal(state.delta, jstate.delta)
    np.testing.assert_array_equal(state.route, jstate.route)


# --------------------------------------------------------------- forecast
FORECASTERS = [
    ("ZeroForecaster", {}),
    ("PersistenceForecaster", {}),
    ("EWMAForecaster", {}),
    ("EWMAForecaster", {"alpha": 1.0}),
    ("SeasonalForecaster", {"period": 8}),
    ("SeasonalForecaster", {"period": 3, "alpha": 0.6, "season_alpha": 0.2}),
]


def _history(seed: int, w: int) -> np.ndarray:
    """A diurnal intensity series with noise and a zero window."""
    rng = np.random.default_rng(seed)
    t = np.arange(w)
    x = 5.0 + 4.0 * np.sin(2 * np.pi * t / 8) + rng.random(w)
    if w > 3:
        x[3] = 0.0
    return x


@pytest.mark.parametrize("name,kw", FORECASTERS, ids=lambda x: str(x))
def test_forecasters_match_jax(name, kw):
    got, want = getattr(demand, name)(**kw), getattr(jax_demand, name)(**kw)
    assert got.name == want.name
    for seed, w in ((0, 0), (1, 1), (2, 5), (3, 24), (4, 40)):
        series = _history(seed, w)
        for horizon in (1, 2, 7):
            assert got.forecast(series, horizon) == want.forecast(series, horizon)


@pytest.mark.parametrize("name,kw", [("EWMAForecaster", {"alpha": 0.0}),
                                     ("SeasonalForecaster", {"period": 0})])
def test_forecaster_arguments_refused_as_in_jax(name, kw):
    for pkg in (demand, jax_demand):
        with pytest.raises(ValueError):
            getattr(pkg, name)(**kw)
    with pytest.raises(NotImplementedError):
        demand.Forecaster().forecast(np.ones(3))


@pytest.mark.parametrize("name,kw", FORECASTERS[1:], ids=lambda x: str(x))
def test_od_layer_forecast_view_matches_jax(name, kw):
    """The demand plane (already ported) forecasts through each forecaster:
    the same observations give the same forecast view."""
    n_items, D = 50, 4
    layers = (demand.ODDemandLayer(n_items, D, window_s=1.0),
              jax_demand.ODDemandLayer(n_items, D, window_s=1.0))
    rng = np.random.default_rng(3)
    for w in range(12):
        for _ in range(20):
            items = rng.choice(n_items, size=5, replace=False)
            origin = int(rng.integers(0, D))
            for layer in layers:
                layer.observe(items, origin=origin, freq=1.0 + (w % 3))
        for layer in layers:
            layer.advance_to(float(w + 1))
    got = layers[0].forecast(getattr(demand, name)(**kw), horizon=2)
    want = layers[1].forecast(getattr(jax_demand, name)(**kw), horizon=2)
    np.testing.assert_array_equal(got.read_rates, want.read_rates)
    np.testing.assert_array_equal(got.item_heat, want.item_heat)


# ----------------------------------------------------------------- export
class _Ticks:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _record(pkg):
    """The same spans and instruments into one package's tracer and
    registry: nested spans, overlapping roots on one track, explicit
    records with tags, counters with tags, a gauge and a histogram."""
    tr = pkg.Tracer(clock=_Ticks(), enabled=True)
    with tr.span("store.serve_batch", track="store", size=64):
        with tr.span("route", track="store"):
            pass
    r0 = tr.record("request", 0.0005, 0.0042, track="requests", origin=1, dc="eu")
    tr.record("queue", 0.0005, 0.0011, track="requests", parent=r0)
    tr.record("request", 0.0010, 0.0030, track="requests", origin=2)
    tr.record("wave", 0.0, 1 / 3, track="migration", moves=17)
    reg = pkg.MetricsRegistry(enabled=True)
    reg.counter("serving.requests").inc(12)
    reg.counter("serving.wan_bytes_link", src=0, dst=3).inc(1234.5)
    reg.gauge("store.items").set(530175)
    reg.histogram("serving.request_latency_s").observe_many(
        np.random.default_rng(0).random(200) * 0.3)
    return tr, reg


def test_chrome_trace_is_byte_identical_to_jax(tmp_path):
    (tr, _), (jtr, _) = _record(obs), _record(jax_obs)
    got = obs.export_chrome_trace(tr, str(tmp_path / "port.json"))
    want = jax_obs.export_chrome_trace(jtr, str(tmp_path / "jax.json"))
    assert got == want
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert got.count('"ph":"X"') == 6


@pytest.mark.parametrize("with_tracer", [True, False])
def test_text_dashboard_is_identical_to_jax(with_tracer):
    (tr, reg), (jtr, jreg) = _record(obs), _record(jax_obs)
    got = obs.text_dashboard(reg, tr if with_tracer else None)
    want = jax_obs.text_dashboard(jreg, jtr if with_tracer else None)
    assert got == want
    assert ("== spans ==" in got) == with_tracer
    # empty registry and tracer
    assert obs.text_dashboard(obs.MetricsRegistry(), obs.Tracer(enabled=True)) == (
        jax_obs.text_dashboard(jax_obs.MetricsRegistry(), jax_obs.Tracer(enabled=True)))


# ----------------------------------------------------------------- config
def test_geolayer_config_matches_jax():
    got, want = geolayer.CONFIG, jax_geolayer.CONFIG
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    pc, jpc = got.placement_config(), want.placement_config()
    assert [f.name for f in dataclasses.fields(pc)] == [f.name for f in dataclasses.fields(jpc)]
    for f in dataclasses.fields(jpc):
        assert tuple(getattr(pc, f.name)) == tuple(getattr(jpc, f.name)) if f.name == "dhd" \
            else getattr(pc, f.name) == getattr(jpc, f.name), f.name
    from repro_torch.configs import list_archs

    assert "geolayer" not in list_archs()  # a system config, not an arch
