"""The demand plane's observe on the serving path: the same tables as the
JAX package's, bit for bit.

``ODDemandLayer.observe`` scatters an access batch's weight into the heat
and od tables with ``np.add.at`` (duplicate ids add up).  The JAX package
hands it a Python float, whose casting loop adds in float64 and rounds each
sum to float32; the port hands a weight that float32 holds exactly as a
float32 scalar, and any other weight as the JAX package does.  On tables
with fractional heat and repeated ids, the tables must equal the JAX
package's layer and a per-id loop of those roundings after every batch.
"""
import numpy as np
import pytest

from repro.demand import ODDemandLayer as JaxDemandLayer
from repro_torch.demand import ODDemandLayer


@pytest.mark.parametrize("freq", [1.0, 0.375, 0.1],
                         ids=["unit", "a float32 fraction", "not a float32 value"])
def test_observe_matches_jax_and_a_per_id_loop(freq):
    rng = np.random.default_rng(int(freq * 1000))
    n_items, D = 500, 3
    port, jax_layer = ODDemandLayer(n_items, D), JaxDemandLayer(n_items, D)
    for _ in range(6):  # fractional heat, different from id to id
        origin, w = int(rng.integers(0, D)), float(rng.random() * 100)
        ids = rng.choice(n_items, n_items // 2, replace=False)
        for layer in (port, jax_layer):
            layer.observe(ids, origin=origin, freq=w)
    want = port.heat.copy()
    assert (want != np.round(want)).any()
    np.testing.assert_array_equal(port.heat, jax_layer.heat)
    for _ in range(4):
        origin = int(rng.integers(0, D))
        ids = rng.integers(0, 60, 900)  # every id many times over
        port.observe(ids, origin=origin, freq=freq)
        jax_layer.observe(ids, origin=origin, freq=freq)
        for i in ids.tolist():
            want[origin, i] = np.float32(float(want[origin, i]) + freq)
        np.testing.assert_array_equal(port.heat, want)
        np.testing.assert_array_equal(port.heat, jax_layer.heat)
        np.testing.assert_array_equal(port.od, jax_layer.od)
    assert port.total_observed == jax_layer.total_observed
