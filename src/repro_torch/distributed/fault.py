"""Fault tolerance + elasticity: failure simulation, elastic remesh,
straggler detection and mitigation.

On a real cluster, failures surface as missing heartbeats; here the
``FailureSimulator`` injects them deterministically.  The sharded store
feeds each shard's measured serve time to a :class:`StragglerDetector`,
which the admission controller reads.  :func:`reshard_tree` places a
host-resident checkpoint onto a (new) mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FailureSimulator",
    "elastic_mesh_shape",
    "reshard_tree",
    "StragglerDetector",
    "StragglerMitigator",
]


@dataclasses.dataclass
class FailureEvent:
    step: int
    n_failed: int  # devices lost


class FailureSimulator:
    """Deterministic failure schedule: at listed steps, N devices die."""

    def __init__(self, events: Sequence[Tuple[int, int]] = ()) -> None:
        self.events = [FailureEvent(s, n) for s, n in events]
        self.failed_devices = 0

    def check(self, step: int) -> Optional[FailureEvent]:
        for e in self.events:
            if e.step == step:
                self.failed_devices += e.n_failed
                return e
        return None


def elastic_mesh_shape(
    n_devices: int, prefer_model: int = 16, multi_pod: bool = False
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest usable mesh after losing devices: keep the model axis if it
    divides, shrink data parallelism (elastic DP is loss-free; elastic TP
    would need weight resharding beyond DP)."""
    model = prefer_model
    while model > 1 and n_devices % model != 0:
        model //= 2
    rest = n_devices // model
    if multi_pod and rest % 2 == 0 and rest >= 2:
        return (2, rest // 2, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")


def reshard_tree(tree: Any, mesh, spec_tree: Any) -> Any:
    """Place a host-resident (numpy) tree of nested dicts onto a (new) mesh
    with the given specs: each rank keeps its own slice of each leaf as a
    DTensor.  The elastic-restart path: checkpoints are stored unsharded,
    so any surviving mesh shape can load them."""
    import torch

    from .sharding import distribute_tree

    dev = mesh.device_type

    def to_torch(t):
        if isinstance(t, dict):
            return {k: to_torch(v) for k, v in t.items()}
        return torch.as_tensor(np.asarray(t), device=dev)

    return distribute_tree(to_torch(tree), mesh, spec_tree)


class StragglerDetector:
    """EWMA per-shard latency tracker with a median-relative lag flag.

    The detection core shared by the data-pipeline mitigator below and the
    sharded serving path: :class:`~repro_torch.distributed.ShardedGeoGraphStore`
    feeds each shard's measured ``serve_batch`` wall time through
    :meth:`observe`, and the admission controller reads :meth:`is_straggler`
    to attribute a deadline miss to a lagging shard instead of the WAN fetch.
    """

    def __init__(self, n_shards: int, threshold: float = 1.8, alpha: float = 0.3):
        self.lat = np.zeros(n_shards)
        self.threshold = threshold
        self.alpha = alpha

    @property
    def n_shards(self) -> int:
        return len(self.lat)

    def observe(self, shard: int, seconds: float) -> None:
        if self.lat[shard] == 0:
            self.lat[shard] = seconds
        else:
            self.lat[shard] = (1 - self.alpha) * self.lat[shard] + self.alpha * seconds

    def ewma(self, shard: int) -> float:
        return float(self.lat[shard])

    def median(self) -> float:
        """Median EWMA over shards with at least one observation (0 if none)."""
        active = self.lat > 0
        return float(np.median(self.lat[active])) if active.any() else 0.0

    def is_straggler(self, shard: int) -> bool:
        """True when ``shard`` lags the active-shard median by ``threshold``x.

        Needs >= 2 observed shards (one shard has no fleet to lag behind)."""
        active = self.lat > 0
        if not (0 <= shard < len(self.lat)) or active.sum() < 2:
            return False
        return bool(self.lat[shard] > self.threshold * np.median(self.lat[active]))

    def flagged(self) -> List[int]:
        """Shard ids currently flagged as stragglers."""
        return [s for s in range(len(self.lat)) if self.is_straggler(s)]

    def snapshot(self) -> Dict[str, object]:
        return {
            "ewma_s": self.lat.tolist(),
            "median_s": self.median(),
            "threshold": self.threshold,
            "flagged": self.flagged(),
        }


class StragglerMitigator(StragglerDetector):
    """Host-side straggler mitigation for the data pipeline.

    Tracks per-shard step latencies (EWMA); when one feeder lags the median
    by ``threshold``x, its next batches are re-dispatched to the fastest
    feeder (bounded work stealing)."""

    def __init__(self, n_shards: int, threshold: float = 1.8, alpha: float = 0.3):
        super().__init__(n_shards, threshold=threshold, alpha=alpha)
        self.reassigned: Dict[int, int] = {}

    def plan(self) -> Dict[int, int]:
        """shard -> substitute feeder for shards flagged as stragglers."""
        active = self.lat > 0
        if active.sum() < 2:
            return {}
        med = float(np.median(self.lat[active]))
        fastest = int(np.argmin(np.where(active, self.lat, np.inf)))
        out = {}
        for s in np.where(active)[0]:
            if self.lat[s] > self.threshold * med and s != fastest:
                out[int(s)] = fastest
        self.reassigned = out
        return out
