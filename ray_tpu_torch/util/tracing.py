"""Tracing spans (a copy of ``ray_tpu/util/tracing.py``): spans carry
(trace_id, span_id, parent_id, name, start/end, attributes); finished
spans land in a bounded in-memory buffer and optionally a JSONL file,
and feed the flight recorder.  Off until ``enable_tracing()``: a
disabled ``span`` yields None and records nothing.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

_enabled = False
_lock = threading.Lock()
_finished: "collections.deque" = collections.deque(maxlen=10000)
_export_path: Optional[str] = None
_tls = threading.local()


def enable_tracing(export_file: Optional[str] = None) -> None:
    """Turn tracing on (parity: RAY_TRACING_ENABLED +
    _tracing_startup_hook)."""
    global _enabled, _export_path
    _enabled = True
    _export_path = export_file


def disable_tracing() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def finished_spans() -> List[Dict[str, Any]]:
    with _lock:
        return list(_finished)


def clear() -> None:
    with _lock:
        _finished.clear()


def _current() -> Optional[Dict[str, str]]:
    return getattr(_tls, "ctx", None)


def capture_context() -> Optional[Dict[str, str]]:
    """Snapshot the caller's span context for injection into a task
    (parity: the serialized span context in task metadata)."""
    cur = _current()
    if cur is not None:
        # An activated context counts even when this process never
        # called enable_tracing itself — worker processes carry the
        # driver's context this way.
        return {"trace_id": cur["trace_id"], "span_id": cur["span_id"]}
    if not _enabled:
        return None
    # Root: start a fresh trace at the call boundary.
    return {"trace_id": uuid.uuid4().hex, "span_id": ""}


def _finish(rec: Dict[str, Any]) -> None:
    with _lock:
        _finished.append(rec)
        if _export_path:
            try:
                with open(_export_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                pass
    # Feed the always-on flight recorder (one ring-buffer append; the
    # recorder must never take the tracer down with it).
    try:
        from ray_tpu_torch.util import flight_recorder
        flight_recorder.record(
            "span", name=rec.get("name"), start=rec.get("start"),
            end=rec.get("end"),
            request_id=(rec.get("attributes") or {}).get("request_id"))
    except Exception:
        pass


@contextlib.contextmanager
def span(name: str, ctx: Optional[Dict[str, str]] = None,
         attributes: Optional[Dict[str, Any]] = None):
    """Open a span; ``ctx`` (from capture_context) makes it a child of
    the remote caller's span."""
    if not _enabled:
        yield None
        return
    parent = ctx if ctx is not None else _current()
    rec = {
        "trace_id": (parent or {}).get("trace_id") or uuid.uuid4().hex,
        "span_id": uuid.uuid4().hex[:16],
        "parent_id": (parent or {}).get("span_id") or "",
        "name": name,
        "start": time.time(),
        "attributes": dict(attributes or {}),
    }
    prev = _current()
    _tls.ctx = {"trace_id": rec["trace_id"], "span_id": rec["span_id"]}
    try:
        yield rec
    except BaseException as e:
        rec["attributes"]["error"] = repr(e)
        raise
    finally:
        rec["end"] = time.time()
        _tls.ctx = prev
        _finish(rec)


def record_span(name: str, start: float, end: float, *,
                ctx: Optional[Dict[str, str]] = None,
                span_id: Optional[str] = None,
                attributes: Optional[Dict[str, Any]] = None,
                ) -> Optional[Dict[str, Any]]:
    """Append an already-measured span (wall-clock ``start``/``end``)
    without touching the thread-local context.  For code that measures
    phases itself — an engine loop stamping request lifecycles, a
    streaming executor closing an operator stage — where a live
    ``with span(...)`` cannot bracket the work.  ``ctx`` is the PARENT
    context; ``span_id`` pins the id so children recorded elsewhere can
    parent to a span before it is finished.  Returns the record (its
    trace_id/span_id make a ctx for children), or None when tracing is
    disabled."""
    if not _enabled:
        return None
    rec = {
        "trace_id": (ctx or {}).get("trace_id") or uuid.uuid4().hex,
        "span_id": span_id or uuid.uuid4().hex[:16],
        "parent_id": (ctx or {}).get("span_id") or "",
        "name": name,
        "start": start,
        "end": end,
        "attributes": dict(attributes or {}),
    }
    _finish(rec)
    return rec
