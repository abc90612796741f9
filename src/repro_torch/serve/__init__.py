"""Serving control plane: Client → AdmissionController → store → Policy.

``StoreClient`` is the read-path API (futures-style handles with origin,
deadline and priority class), ``AdmissionController`` the event-loop
scheduler with latency-aware adaptive batching and per-origin fairness,
``MaintenancePolicy`` the budgeted background scheduler that interleaves
migration waves / compaction / heat maintenance into idle gaps and feeds
measured wave transfer times back into the window estimate.  The control
plane is numpy on a simulated clock; the store it drives (a
``GeoGraphStore`` or a ``ShardedGeoGraphStore``) runs its kernels on its
own device.

:mod:`repro_torch.serve.engine` is the per-site LM slot engine (unrelated to
the graph-store path) and is imported lazily, so importing the control plane
never loads the model zoo.
"""
from .client import BULK, INTERACTIVE, RequestHandle, StoreClient  # noqa: F401
from .policy import MaintenanceConfig, MaintenancePolicy  # noqa: F401
from .scheduler import (  # noqa: F401
    AdmissionConfig,
    AdmissionController,
    BatchRecord,
    SimClock,
)

__all__ = [
    "RequestHandle",
    "StoreClient",
    "INTERACTIVE",
    "BULK",
    "AdmissionConfig",
    "AdmissionController",
    "BatchRecord",
    "SimClock",
    "MaintenanceConfig",
    "MaintenancePolicy",
]


def __getattr__(name):
    # lazy: repro_torch.serve.engine pulls in the transformer zoo, which the
    # graph-store control plane never needs
    if name == "engine":
        import importlib

        module = importlib.import_module(".engine", __name__)
        globals()["engine"] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
