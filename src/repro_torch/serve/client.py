"""Client-facing read-path API of the serving control plane.

The store surface splits three ways (paper §VI serving, run as an online
control problem):

  * :class:`StoreClient` (this module) — what application code holds.
    ``submit()`` takes the request payload *plus its serving contract*
    (origin DC, latency deadline, priority class) and returns a
    futures-style :class:`RequestHandle` immediately; routing happens when
    the :class:`~repro_torch.serve.AdmissionController` drains.
  * ``AdmissionController`` (:mod:`repro_torch.serve.scheduler`) — forms batches
    adaptively and owns the simulated clock.
  * ``MaintenancePolicy`` (:mod:`repro_torch.serve.policy`) — background work in
    the idle gaps.

Handles replace the integer request ids of the retired FIFO frontend: the
result, dispatch/completion timestamps and deadline-miss verdict live on
the handle itself, so no side-table lookup survives the drain.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..core.routing import RouteResult

__all__ = ["RequestHandle", "StoreClient", "INTERACTIVE", "BULK"]

# priority classes: lower value drains first.  Deadlines default per class
# (see AdmissionConfig.default_deadlines); callers can pass any int.
INTERACTIVE = 0
BULK = 1


@dataclasses.dataclass
class RequestHandle:
    """Futures-style handle for one submitted pattern request.

    Timestamps are controller-clock seconds (simulated, deterministic).
    ``result`` is set exactly once, when the batch containing the request
    lands; until then the handle is pending.
    """

    rid: int
    items: np.ndarray
    origin: int
    # keyword-only from here: the legacy GraphRequest dataclass had `result`
    # as the 4th positional field, so a positional `priority` would let old
    # call sites silently stuff a RouteResult into it — force a TypeError
    _: dataclasses.KW_ONLY
    priority: int = INTERACTIVE
    deadline_s: float = math.inf  # latency budget relative to submission
    t_submit: float = 0.0
    t_dispatch: float = math.nan  # batch formation instant
    t_done: float = math.nan  # completion (router busy end + WAN straggler)
    result: Optional[RouteResult] = None

    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def latency_s(self) -> float:
        """Submission-to-completion latency (NaN while pending)."""
        return self.t_done - self.t_submit

    @property
    def wait_s(self) -> float:
        """Queueing delay before the batch was formed (NaN while pending)."""
        return self.t_dispatch - self.t_submit

    @property
    def deadline_missed(self) -> bool:
        return self.done and self.latency_s > self.deadline_s

    def value(self) -> RouteResult:
        """The routing outcome; raises while the request is still queued."""
        if self.result is None:
            raise RuntimeError(f"request {self.rid} is still pending")
        return self.result


class StoreClient:
    """Read-path API bound to one :class:`~repro_torch.serve.AdmissionController`.

    ``submit`` is non-blocking: it registers the request (optionally at a
    future clock time ``at``, for replaying arrival traces) and returns the
    handle.  ``result`` drains the controller until the handle resolves.
    """

    def __init__(self, controller) -> None:
        self.controller = controller

    def submit(
        self,
        items: np.ndarray,
        origin: int,
        deadline_s: Optional[float] = None,
        priority: int = INTERACTIVE,
        at: Optional[float] = None,
    ) -> RequestHandle:
        return self.controller.submit(
            items, origin, deadline_s=deadline_s, priority=priority, at=at
        )

    def submit_pattern(self, pattern, origin: int, **kw) -> RequestHandle:
        return self.submit(pattern.items, origin, **kw)

    def result(self, handle: RequestHandle) -> RouteResult:
        """Resolve ``handle``, draining the controller if needed."""
        if not handle.done:
            self.controller.run_until_idle()
        return handle.value()
