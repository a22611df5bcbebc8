"""Env-gated fail points (a copy of ``fail_point`` and ``FailPointError``
from ``ray_tpu/utils/test_utils.py``), armed by the same
``RAYTPU_FAILPOINTS`` variable: a comma list of ``point[:count]``
entries, count = firings (default 1).  The audit plane's corruption
injectors (``serve/audit.corrupt``) fire through them."""

from __future__ import annotations

import os
import threading
from typing import Optional

from ray_tpu_torch.core.exceptions import PreemptedError


class FailPointError(PreemptedError):
    """Raised by an armed fail point.  Subclasses PreemptedError so a
    failover path treats an injected fault like a real preemption
    (retriable, empty continuation)."""

    def __init__(self, point: str = "", continuation: Optional[dict] = None):
        self.point = point
        super().__init__(f"fail point {point!r} fired", continuation)

    def __reduce__(self):
        return (type(self), (self.point, self.continuation))


_fail_lock = threading.Lock()
_fail_env: Optional[str] = None
_fail_armed: dict = {}


def fail_point(name: str) -> None:
    """Fire an injected fault at a named point when RAYTPU_FAILPOINTS
    arms it; an unarmed point is a near-free no-op, so production code
    calls this unconditionally."""
    global _fail_env
    env = os.environ.get("RAYTPU_FAILPOINTS", "")
    if not env and _fail_env in (None, ""):
        return
    with _fail_lock:
        if env != _fail_env:
            _fail_env = env
            _fail_armed.clear()
            for entry in env.split(","):
                entry = entry.strip()
                if not entry:
                    continue
                point, _, count = entry.partition(":")
                _fail_armed[point] = int(count) if count else 1
        remaining = _fail_armed.get(name, 0)
        if remaining <= 0:
            return
        _fail_armed[name] = remaining - 1
    raise FailPointError(name)
