"""Carry a store's state across as plain numpy arrays.

:func:`store_arrays` reads a built store — of this package or of any
package with the same attribute layout — into a dict of numpy arrays and
scalars.  :func:`store_from_numpy` builds a port store from such a dict
without running placement: it adopts ``state.delta``, rebuilds the layered
graph, route index and demand plane around it, and, under stepwise routing,
checks that the carried ``state.route`` equals the rebuilt nearest-replica
table; under a table routing (``"random"``, ``"greedy"``) it adopts
``state.route`` as it is.  Two stores made this way serve the same
placement, so serving parity does not depend on placement parity.

:func:`streaming_heat_arrays` and :func:`streaming_heat_from_numpy` do the
same for a warm DHD field (``StreamingHeat``), so both packages' warm
updates can start from one field.

:func:`lm_params_from_numpy` turns an LM's params (the JAX package's tree,
as numpy arrays) into the port's, so both packages run one set of weights.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .core.cost import PlacementState
from .core.graph import Graph
from .core.latency import GeoEnvironment
from .core.patterns import Pattern, Workload
from .core.placement import PlacementConfig
from .device import DeviceLike

__all__ = [
    "ENV_FIELDS",
    "F32_PARAMS",
    "GRAPH_FIELDS",
    "HEAT_FIELDS",
    "lm_params_from_numpy",
    "store_arrays",
    "store_from_numpy",
    "streaming_heat_arrays",
    "streaming_heat_from_numpy",
]

GRAPH_FIELDS = ("src", "dst", "node_size", "edge_size", "partition")
ENV_FIELDS = ("rtt_s", "bw_Bps", "c_store", "c_read", "c_write", "c_net")
HEAT_FIELDS = ("cols", "vals", "heat", "q")
# LM params the JAX package uses in f32 (the router's logits, norm gains);
# every other weight is only ever used cast to the config's dtype
F32_PARAMS = frozenset({"router", "g", "kv_norm"})


def store_arrays(store) -> Dict[str, object]:
    """The arrays :func:`store_from_numpy` needs, copied out of ``store``."""
    g, env, wl = store.g, store.env, store.workload
    out: Dict[str, object] = {"n_nodes": int(g.n_nodes), "n_dcs": int(env.n_dcs)}
    for f in GRAPH_FIELDS:
        out[f"graph.{f}"] = np.array(getattr(g, f))
    out["env.names"] = list(env.names)
    for f in ENV_FIELDS:
        out[f"env.{f}"] = np.array(getattr(env, f))
    out["workload.r_xy"] = np.array(wl.r_xy)
    out["workload.w_xy"] = np.array(wl.w_xy)
    pats = wl.patterns
    out["patterns.pid"] = np.array([p.pid for p in pats], dtype=np.int64)
    out["patterns.eta"] = np.array([p.eta for p in pats], dtype=np.float64)
    out["patterns.r_py"] = np.array([np.asarray(p.r_py) for p in pats])
    out["patterns.w_py"] = np.array([np.asarray(p.w_py) for p in pats])
    out["patterns.items"] = [np.array(p.items) for p in pats]
    out["state.delta"] = np.array(store.state.delta)
    out["state.route"] = np.array(store.state.route)
    out["placement"] = store.placement_name
    out["routing"] = store.routing_name
    return out


def store_from_numpy(
    arrays: Dict[str, object],
    config: Optional[PlacementConfig] = None,
    device: DeviceLike = None,
    latency_interval_s: float = 0.100,
):
    """A port :class:`~repro_torch.core.store.GeoGraphStore` serving the
    placement in ``arrays`` under the source store's placement and routing
    names (see :func:`store_arrays` for the keys); ``latency_interval_s``
    must be the one the source store was built with."""
    from .core.store import GeoGraphStore

    g = Graph(
        n_nodes=int(arrays["n_nodes"]),
        **{f: np.array(arrays[f"graph.{f}"]) for f in GRAPH_FIELDS},
    )
    env = GeoEnvironment(
        names=list(arrays["env.names"]),
        **{f: np.array(arrays[f"env.{f}"]) for f in ENV_FIELDS},
    )
    pats = [
        Pattern(
            pid=int(pid), items=np.array(items), r_py=np.array(r), w_py=np.array(w),
            eta=float(eta),
        )
        for pid, items, r, w, eta in zip(
            arrays["patterns.pid"], arrays["patterns.items"],
            arrays["patterns.r_py"], arrays["patterns.w_py"], arrays["patterns.eta"],
        )
    ]
    wl = Workload(
        patterns=pats, n_items=g.n_items, n_dcs=env.n_dcs,
        r_xy=np.array(arrays["workload.r_xy"]), w_xy=np.array(arrays["workload.w_xy"]),
    )
    route = np.array(arrays["state.route"])
    state = PlacementState(delta=np.array(arrays["state.delta"], dtype=bool), route=route)
    store = GeoGraphStore(
        g, env, wl, config=config, device=device, state=state,
        placement=arrays["placement"], routing=arrays["routing"],
        latency_interval_s=latency_interval_s,
    )
    if store.route_index is not None and not np.array_equal(store.route_index.nearest, route):
        raise ValueError("carried state.route is not the nearest-replica table of state.delta")
    return store


def streaming_heat_arrays(sh) -> Dict[str, object]:
    """The state of a built ``StreamingHeat`` (of this package or of any
    package with the same attribute layout) as numpy arrays and scalars."""
    out: Dict[str, object] = {f: np.array(getattr(sh, f)) for f in HEAT_FIELDS}
    out["alpha"] = float(sh.alpha)
    out["n_nodes"] = int(sh.n_nodes)
    out["params"] = tuple(float(x) for x in sh.params)
    out["max_iters"] = int(sh.max_iters)
    out["tol"] = float(sh.tol)
    return out


def streaming_heat_from_numpy(arrays: Dict[str, object], device: DeviceLike = None):
    """A port ``StreamingHeat`` holding the field in ``arrays`` (see
    :func:`streaming_heat_arrays`), its adjacency uploaded to ``device``."""
    from .core.dhd import DHDParams
    from .streaming.delta_dhd import StreamingHeat

    sh = StreamingHeat(
        params=DHDParams(*arrays["params"]), max_iters=int(arrays["max_iters"]),
        tol=float(arrays["tol"]), device=device,
    )
    sh.adopt(
        *(arrays[f] for f in HEAT_FIELDS), alpha=float(arrays["alpha"]),
        n_nodes=int(arrays["n_nodes"]),
    )
    return sh


def lm_params_from_numpy(tree: Dict[str, object], cfg, device: DeviceLike = None):
    """The port's LM params from the JAX package's tree of numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``), on ``device``.

    Leaves named in :data:`F32_PARAMS` stay f32; every other leaf is stored
    in ``cfg.dtype``, the cast the JAX package applies at each use, done once
    with the same rounding (round to nearest even)."""
    import torch

    from .device import resolve_device

    dev = resolve_device(device)

    def conv(node, name: str = ""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        return t.to(device=dev, dtype=torch.float32 if name in F32_PARAMS else cfg.dtype)

    return conv(tree)
