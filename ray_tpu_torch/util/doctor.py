"""Invariant audit plane (a copy of ``ray_tpu/util/doctor.py``).

A registry of named, versioned invariant checks, the structured
``InvariantViolation`` every check emits, the ``raytpu_doctor_*`` metric
families the audit results land in, and the flight-recorder hook that
turns a violation into an incident bundle naming the invariant.

Checks run in two tiers:

  * ``incremental`` — O(slots) conservation sums the engine loop runs
    between dispatches after a slot release dirtied the allocator
    state (page-count conservation, borrow balance, draft-page return);
  * ``deep`` — full walks (pool partition, trie reachability and
    refcount recount, adapter and draft partitions, slot table, ring
    terminal accounting) run on demand, on engine idle, and on
    drain/stop.

The engine-specific check bodies live in ``serve/audit.py``; everything
reports through ``run_audit`` here, so every report has one shape.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

_TELEMETRY = None

# Severity ladder: "critical" = memory-corrupting (a page owned twice,
# a refcount that lets eviction free a live page); "error" = a leak
# (capacity lost forever but nothing corrupts); "warning" =
# control-plane drift (census/broadcast/router disagreement — wrong
# routing, not wrong bytes).
SEVERITIES = ("critical", "error", "warning")

# Tiers — see module docstring.
INCREMENTAL = "incremental"
DEEP = "deep"

# Monotone per-process audit sequence; every violation carries the
# epoch of the audit that found it so re-detections are tellable from
# new corruption.
_EPOCH = itertools.count(1)

_lock = threading.Lock()


def _telemetry():
    """Doctor metric singletons, merged into the engine's telemetry
    dict (llm_engine._telemetry) so the families are declared before
    any audit runs."""
    global _TELEMETRY
    from ray_tpu_torch.util import metrics

    if _TELEMETRY is None:
        _TELEMETRY = {
            "violations": metrics.Counter(
                "raytpu_doctor_violations_total",
                "Invariant violations found by audit checks, by check "
                "name and severity.  Any nonzero count is a bug: "
                "either real state corruption or a stale check.",
                tag_keys=("check", "severity"),
            ),
            "audits": metrics.Counter(
                "raytpu_doctor_audits_total",
                "Audit passes completed, by tier (incremental = "
                "O(dirty-set) conservation sums between dispatches; "
                "deep = full partition/reachability walks).",
                tag_keys=("tier",),
            ),
            "last_violations": metrics.Gauge(
                "raytpu_doctor_last_audit_violations",
                "Violations found by the most recent audit pass "
                "(0 = the last audit was clean).",
            ),
            "last_checks": metrics.Gauge(
                "raytpu_doctor_last_audit_checks",
                "Checks run in the most recent audit pass.",
            ),
            "last_seconds": metrics.Gauge(
                "raytpu_doctor_last_audit_seconds",
                "Wall time of the most recent audit pass.",
            ),
        }
    else:
        reg = metrics.registry()
        for m in _TELEMETRY.values():
            reg.register(m)
    return _TELEMETRY


@dataclasses.dataclass(frozen=True)
class CheckDef:
    """One named invariant.  ``version`` bumps when the invariant's
    DEFINITION changes, so a dashboard comparing violation counts
    across releases knows when the meaning moved under it."""

    name: str
    version: int
    tier: str  # INCREMENTAL or DEEP
    severity: str  # default severity of this check's violations
    description: str


@dataclasses.dataclass
class InvariantViolation:
    """One violated invariant instance — structured, JSON-able, and
    small enough to ride a flight-recorder event verbatim."""

    check: str
    severity: str
    subject: str  # what is wrong (page 7, slot 3, replica r-2, …)
    expected: Any
    actual: Any
    epoch: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {"check": self.check, "severity": self.severity,
                "subject": self.subject, "expected": self.expected,
                "actual": self.actual, "epoch": self.epoch}


_REGISTRY: Dict[str, CheckDef] = {}


def register_check(name: str, version: int, tier: str, severity: str,
                   description: str) -> CheckDef:
    """Idempotently register one invariant definition.  Re-registering
    the same name with a different version/tier raises — two modules
    disagreeing about what a check MEANS is itself a bug."""
    cd = CheckDef(name, int(version), tier, severity, description)
    with _lock:
        old = _REGISTRY.get(name)
        if old is not None:
            if (old.version, old.tier) != (cd.version, cd.tier):
                raise ValueError(
                    f"doctor check {name!r} re-registered with "
                    f"v{cd.version}/{cd.tier}, already "
                    f"v{old.version}/{old.tier}")
            return old
        _REGISTRY[name] = cd
    return cd


def run_audit(proc: str,
              check_fns: List[Tuple[CheckDef,
                                    Callable[[], List[InvariantViolation]]]],
              *, deep: bool) -> Dict[str, Any]:
    """Run one audit pass and report it.

    Side effects per the doctor contract: every violation increments
    ``raytpu_doctor_violations_total{check,severity}``; the
    ``raytpu_doctor_last_audit_*`` gauges are set from this pass; each
    distinct violated check fires ONE flight-recorder trigger (reason
    ``invariant``, detail = the check name) so the cursor-ship path
    auto-dumps a cross-process bundle naming the invariant.  A check
    body that raises is itself reported as a violation of that check
    (severity error) — a broken auditor must never look like a clean
    bill of health."""
    t0 = time.monotonic()
    epoch = next(_EPOCH)
    tm = _telemetry()
    rows: List[Dict[str, Any]] = []
    total = 0
    for cd, fn in check_fns:
        try:
            found = list(fn())
        except Exception as e:
            found = [InvariantViolation(
                check=cd.name, severity="error",
                subject="check-body",
                expected="check runs without raising",
                actual=repr(e))]
        for v in found:
            v.epoch = epoch
        total += len(found)
        rows.append({
            "check": cd.name, "version": cd.version, "tier": cd.tier,
            "status": "violated" if found else "ok",
            "violations": [v.to_dict() for v in found],
        })
        for v in found:
            tm["violations"].inc(
                tags={"check": v.check, "severity": v.severity})
    seconds = time.monotonic() - t0
    tm["audits"].inc(tags={"tier": DEEP if deep else INCREMENTAL})
    tm["last_violations"].set(float(total))
    tm["last_checks"].set(float(len(rows)))
    tm["last_seconds"].set(seconds)
    _fire_triggers(rows)
    return {"proc": proc, "epoch": epoch, "deep": bool(deep),
            "checks_run": len(rows), "violations": total,
            "audit_seconds": seconds, "checks": rows}


def _fire_triggers(rows: List[Dict[str, Any]]) -> None:
    """One flight-recorder trigger per distinct violated check (not
    per violation — a wholesale partition breach must produce one
    bundle, not hundreds)."""
    for row in rows:
        if row["status"] != "violated":
            continue
        first = row["violations"][0]
        try:
            from ray_tpu_torch.util import flight_recorder
            flight_recorder.trigger(
                "invariant", detail=row["check"],
                check=row["check"], severity=first["severity"],
                subject=first["subject"],
                n_violations=len(row["violations"]))
        except Exception:
            pass  # the audit verdict must not depend on the recorder


def merge_reports(reports: List[Dict[str, Any]], *,
                  deep: bool) -> Dict[str, Any]:
    """Fold per-process reports into the aggregate shape the surfaces
    serve (``state.doctor_report`` / ``GET /api/v0/doctor`` /
    ``raytpu doctor``)."""
    reports = [r for r in reports if isinstance(r, dict)]
    return {
        "deep": bool(deep),
        "checks_run": sum(int(r.get("checks_run", 0)) for r in reports),
        "violations": sum(int(r.get("violations", 0)) for r in reports),
        "audit_seconds": sum(float(r.get("audit_seconds", 0.0))
                             for r in reports),
        "reports": reports,
    }
