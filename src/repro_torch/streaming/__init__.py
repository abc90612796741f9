"""Streaming-update subsystem: incremental maintenance of the GeoLayer store
under topology churn (paper §V "Update Maintenance", made structural).

Pipeline per mutation batch:

  1. :mod:`mutation_log`  — batch vertex/edge inserts+deletes into a
     delta-CSR overlay; stable item ids, tombstoned deletes, periodic compact.
  2. :mod:`repro_torch.core.layered_graph.repair_layered_graph` — re-level only the
     layers whose DC-pair presence a batch invalidated.
  3. :mod:`delta_dhd`     — warm-start the DHD steady state from the previous
     equilibrium; frontier-local pre-solve through the ELL hot path.
  4. :mod:`migration`     — turn heat deltas into a cost-bounded replica
     move-set (vectorized planner), pack its adds into per-(src, dst)
     transfer waves under the Table I link bandwidth budgets, and apply them
     wave by wave, validated against the Eq. 6 constraints.

The public store entry points are ``GeoGraphStore.apply_updates()`` and
``GeoGraphStore.flush_migrations()``.
"""
from .mutation_log import (  # noqa: F401
    ApplyResult,
    DeltaCSR,
    DeltaGraph,
    MutationBatch,
    MutationLog,
    compact_workload,
    random_churn_batch,
)
from .delta_dhd import StreamingHeat, WarmStats  # noqa: F401
from .migration import (  # noqa: F401
    MigrationPlan,
    MigrationSchedule,
    Move,
    TransferBatch,
    TransferWave,
    apply_plan,
    plan_migrations,
    schedule_transfers,
)

__all__ = [
    "MutationLog",
    "MutationBatch",
    "DeltaCSR",
    "DeltaGraph",
    "ApplyResult",
    "random_churn_batch",
    "compact_workload",
    "StreamingHeat",
    "WarmStats",
    "Move",
    "MigrationPlan",
    "MigrationSchedule",
    "TransferBatch",
    "TransferWave",
    "plan_migrations",
    "schedule_transfers",
    "apply_plan",
]
