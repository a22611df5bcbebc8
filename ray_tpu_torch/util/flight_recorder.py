"""Always-on bounded flight recorder for the serving planes (a copy of
``ray_tpu/util/flight_recorder.py``).

The process keeps the last N seconds of observability events (span
finishes from util/tracing, request-ring transitions from
serve/request_events, metric-counter deltas) in a bounded ring buffer;
recording costs one deque append per event.  ``trigger()`` marks an
incident (an SLO miss, an admission shed, an invariant violation),
bumps ``raytpu_flightrec_triggers_total{reason}``, samples the counter
deltas and, when a dump directory is configured
(``configure(dump_dir=...)`` or ``RAYTPU_FLIGHTREC_DIR``), writes a
bundle (events.json, metrics.prom, manifest.json), rate-limited so a
storm writes one bundle.  The JAX package's cross-process shipping of
events serves its runtime, which the port does not host.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_TELEMETRY = None

_lock = threading.Lock()
_seq = 0                       # monotone event id, for the ship cursor
_events: "collections.deque" = collections.deque(maxlen=4096)
_window_s = 60.0               # how far back a bundle reaches
_dump_dir: Optional[str] = os.environ.get("RAYTPU_FLIGHTREC_DIR") or None
_auto_dump = True              # dump on trigger when a dump dir is set
_dump_n = 0
_last_auto_dump_t = 0.0
_min_dump_interval_s = 2.0
_counter_baseline: Dict[str, float] = {}


def _telemetry():
    """Flight-recorder metric singletons (re-registered on refetch —
    see serve/llm_engine._telemetry for the registry-clear rationale)."""
    global _TELEMETRY
    from ray_tpu_torch.util import metrics

    if _TELEMETRY is None:
        _TELEMETRY = {
            "events": metrics.Gauge(
                "raytpu_flightrec_events",
                "Events currently held in this process's flight-"
                "recorder ring buffer.",
            ),
            "triggers": metrics.Counter(
                "raytpu_flightrec_triggers_total",
                "Flight-recorder trigger events (slo_miss / shed / "
                "retry_storm / autoscale_veto / manual), by reason.",
                tag_keys=("reason",),
            ),
            "dumps": metrics.Counter(
                "raytpu_flightrec_dumps_total",
                "Flight-recorder dump bundles written by this process.",
            ),
        }
    else:
        for m in _TELEMETRY.values():
            metrics.registry().register(m)
    return _TELEMETRY


def configure(window_s: Optional[float] = None,
              capacity: Optional[int] = None,
              dump_dir: Optional[str] = None,
              auto_dump: Optional[bool] = None,
              min_dump_interval_s: Optional[float] = None) -> None:
    """Adjust the recorder.  All arguments optional; None = keep.
    Events older than the current window are dropped on every call, so
    a shrunk window takes effect at once."""
    global _window_s, _events, _dump_dir, _auto_dump, _min_dump_interval_s
    with _lock:
        if window_s is not None:
            _window_s = float(window_s)
        if capacity is not None:
            _events = collections.deque(_events, maxlen=int(capacity))
        if dump_dir is not None:
            _dump_dir = dump_dir or None
        if auto_dump is not None:
            _auto_dump = bool(auto_dump)
        if min_dump_interval_s is not None:
            _min_dump_interval_s = float(min_dump_interval_s)
        horizon = time.time() - _window_s
        _events = collections.deque(
            (e for e in _events if e["ts"] >= horizon),
            maxlen=_events.maxlen)


def clear() -> None:
    """Drop every recorded event and reset cursors (tests)."""
    global _seq, _dump_n, _last_auto_dump_t
    with _lock:
        _events.clear()
        _counter_baseline.clear()
        _seq = _dump_n = 0
        _last_auto_dump_t = 0.0


def record(kind: str, **fields: Any) -> int:
    """Append one event to the local ring.  Cheap and always on."""
    global _seq
    ev = {"ts": time.time(), "kind": kind}
    ev.update(fields)
    with _lock:
        _seq += 1
        ev["seq"] = _seq
        _events.append(ev)
        n = len(_events)
    try:
        _telemetry()["events"].set(float(n))
    except Exception:
        pass  # metrics plane unavailable (interpreter teardown)
    return ev["seq"]


def _sample_counter_deltas_locked(now: float) -> None:
    """Diff counter families against the last sample and record one
    ``metric_delta`` event per family that moved (the "metric-delta"
    third of the event feed).  Caller holds ``_lock``."""
    global _seq
    try:
        from ray_tpu_torch.util import metrics
        fams = metrics.snapshot_samples()
    except Exception:
        return
    for fam, typ, _help, samples in fams:
        if typ != "counter" or fam.startswith("raytpu_flightrec_"):
            continue
        total = sum(s[2] for s in samples)
        prev = _counter_baseline.get(fam)
        _counter_baseline[fam] = total
        if prev is None or total == prev:
            continue
        _seq += 1
        _events.append({"ts": now, "seq": _seq, "kind": "metric_delta",
                        "family": fam, "delta": total - prev,
                        "total": total})


def trigger(reason: str, request_id: Optional[str] = None,
            detail: Optional[str] = None, **fields: Any) -> Optional[str]:
    """Record an incident trigger; auto-dump when configured.  Returns
    the bundle path when a dump was written, else None.  ``detail``
    refines the reason without widening the counter's label set (the
    doctor passes the violated check's name here, so the bundle
    manifest names the invariant while the reason label stays
    ``invariant``)."""
    now = time.time()
    with _lock:
        global _seq
        _seq += 1
        ev = {"ts": now, "seq": _seq, "kind": "trigger", "reason": reason,
              "request_id": request_id}
        if detail is not None:
            ev["detail"] = detail
        ev.update(fields)
        _events.append(ev)
        _sample_counter_deltas_locked(now)
    try:
        _telemetry()["triggers"].inc(tags={"reason": reason})
    except Exception:
        pass
    return _maybe_auto_dump(reason, detail=detail)


def _maybe_auto_dump(reason: str,
                     detail: Optional[str] = None) -> Optional[str]:
    global _last_auto_dump_t
    with _lock:
        if not (_dump_dir and _auto_dump):
            return None
        now = time.time()
        if now - _last_auto_dump_t < _min_dump_interval_s:
            return None
        _last_auto_dump_t = now
    return dump(reason=reason, detail=detail)


def snapshot(request_id: Optional[str] = None,
             window_s: Optional[float] = None) -> Dict[str, List[Dict]]:
    """The recent ring as ``{"driver": [...]}`` (the JAX package's
    per-process shape, one process here).  ``request_id`` filters to one
    request's events plus triggers."""
    horizon = time.time() - (window_s if window_s is not None
                             else _window_s)

    def keep(e: Dict[str, Any]) -> bool:
        if e["ts"] < horizon:
            return False
        if request_id is None:
            return True
        return e.get("request_id") == request_id or e["kind"] == "trigger"

    with _lock:
        return {"driver": [dict(e) for e in _events if keep(e)]}


def dump(reason: str = "manual", dump_dir: Optional[str] = None,
         detail: Optional[str] = None) -> Optional[str]:
    """Write a bundle directory (events.json + metrics.prom +
    manifest.json) and return its path; None when no directory is
    configured.  Manual dumps bypass the auto-dump rate limit.
    ``detail`` (e.g. the violated invariant's check name) lands in the
    manifest next to the reason."""
    global _dump_n
    d = dump_dir or _dump_dir
    if not d:
        return None
    with _lock:
        _dump_n += 1
        n = _dump_n
    path = os.path.join(d, f"flightrec-{n:04d}-{reason}")
    os.makedirs(path, exist_ok=True)
    events = snapshot()
    with open(os.path.join(path, "events.json"), "w") as f:
        json.dump({"reason": reason, "created_at": time.time(),
                   "window_s": _window_s, "events": events}, f, indent=1)
    try:
        from ray_tpu_torch.util import metrics
        with open(os.path.join(path, "metrics.prom"), "w") as f:
            f.write(metrics.export_prometheus())
    except Exception:
        pass
    # No history.json: the JAX package's bundle adds a trailing
    # time-series window from util/timeseries, which the port does
    # not keep (history_procs stays empty).
    history_procs: List[str] = []
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"reason": reason, "detail": detail,
                   "created_at": time.time(),
                   "procs": sorted(events),
                   "history_procs": history_procs,
                   "n_events": sum(len(v) for v in events.values())},
                  f, indent=1)
    try:
        _telemetry()["dumps"].inc()
    except Exception:
        pass
    return path
