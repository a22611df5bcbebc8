"""The serving errors of the port (a copy of ``RayTpuError``,
``PreemptedError`` and ``ShedError`` from ``ray_tpu/core/exceptions.py``,
with their pickling).  The task and actor errors of the JAX package's
runtime stay there: the port hosts no runtime."""

from __future__ import annotations

from typing import Optional


class RayTpuError(Exception):
    pass


class PreemptedError(RayTpuError):
    """The engine serving this request was drained before the request
    finished.  Carries the continuation payload: everything another
    engine needs to resume generation with one re-prefill and no token
    lost,

        {"prompt": [...], "tokens": [... generated so far ...],
         "temperature": float, "request_id": str, "adapter_id": str}

    Retriable; not a failure of the request itself."""

    def __init__(self, reason: str = "replica preempted",
                 continuation: Optional[dict] = None):
        self.reason = reason
        self.continuation = continuation or {}
        generated = len(self.continuation.get("tokens", ()))
        super().__init__(
            f"{reason} (continuation: {generated} generated tokens)")

    def __reduce__(self):
        return (type(self), (self.reason, self.continuation))


class ShedError(RayTpuError):
    """The engine refused to ADMIT this request: its admission queue is
    already older than the SLO budget, so queuing it could only give a
    late answer.  No work was started; the caller may retry (ideally
    after easing off)."""

    def __init__(self, reason: str = "request shed: admission queue over "
                 "SLO budget", queue_age_s: float = 0.0):
        self.reason = reason
        self.queue_age_s = float(queue_age_s)
        super().__init__(f"{reason} (queue age {self.queue_age_s:.3f}s)")

    def __reduce__(self):
        return (type(self), (self.reason, self.queue_age_s))
