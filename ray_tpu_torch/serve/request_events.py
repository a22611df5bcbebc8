"""Request-lifecycle event ring for the serving plane (a copy of
``ray_tpu/serve/request_events.py``).

Every ``LLMEngine`` owns a bounded ring recording each request's state
machine

    QUEUED → PREFILLING → DECODING → FINISHED | FAILED | CANCELLED
                                   | PREEMPTED (drained attempt)
    SHED (refused at admission: queue age over the SLO budget)

with wall-clock timestamps, token counts, slot/page assignment and the
terminal cause.  Rings register into a process-local weak registry (one
entry per live engine); ``snapshot_rows`` lists every known request.  A
caller may install a request id in a context variable
(``set_request_id``) for ``LLMEngine.submit`` to pick up, so spans, log
lines and this ring agree on a request's name.  ``stitch_request``
joins a request's rows across attempts into one view (the latency
waterfall's input).

The JAX package's cross-process rows and chrome-trace rows serve its
runtime, state API and timeline, which the port does not host.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

# Request state vocabulary (the serving analogue of common.proto's
# TaskStatus in core/events.py).  RETRYING is a router-side state: the
# request's current attempt died (replica preempted or killed) and a
# new attempt is being enqueued on a surviving replica.  PREEMPTED is
# the engine-side terminal for a drained request — the *attempt* ended
# there, the request itself continues elsewhere, so it is deliberately
# distinct from FAILED.
QUEUED = "QUEUED"
PREFILLING = "PREFILLING"
DECODING = "DECODING"
RETRYING = "RETRYING"
# MIGRATING is the disaggregated-serving sibling of RETRYING (also
# router-side, also non-terminal): the prefill attempt finished, its KV
# pages landed on a decode replica, and the stream is being resumed
# there (serve/kv_transfer MigrationHandoff) — a planned handoff, not a
# failure.
MIGRATING = "MIGRATING"
FINISHED = "FINISHED"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
PREEMPTED = "PREEMPTED"
# SHED is the admission-control terminal: the engine refused to queue
# the request because its admission queue was already older than the
# SLO budget (EngineConfig.shed_queue_age_s).  Deliberately distinct
# from FAILED — no attempt ever ran, no work was lost, and the caller
# saw an immediate clean backpressure error instead of a timeout.
SHED = "SHED"

TERMINAL_STATES = (FINISHED, FAILED, CANCELLED, PREEMPTED, SHED)

@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle (the serving analogue of TaskAttempt)."""

    request_id: str
    engine: str
    state_ts: Dict[str, float] = dataclasses.field(default_factory=dict)
    prompt_tokens: int = 0
    generated_tokens: int = 0
    # Slot/page assignment: None until admitted; num_pages stays None on
    # the non-paged (slot-cache) engine — absent, not zero.
    slot: Optional[int] = None
    num_pages: Optional[int] = None
    terminal_cause: Optional[str] = None
    # Failover bookkeeping (router rings): attempt is the current
    # 0-based attempt number; attempts accumulates one row per retry
    # with the replica it left and why — the "attempt history" shown by
    # ``raytpu list requests --detail``.
    attempt: int = 0
    attempts: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # Prompt tokens served from the engine's prefix cache at admission
    # (0 = cold prefill, or the cache is off) — joins with ttft_s for
    # TTFT-by-hit-depth.
    prefix_hit: int = 0
    # LoRA adapter the request decodes under ("" = base model) — the
    # multi-tenant attribution key for `raytpu list requests`.
    adapter_id: str = ""
    # Speculative decoding: draft tokens proposed / accepted for this
    # request across its verify rounds (both 0 = the request never
    # speculated — temperature > 0, adapter traffic, or spec off).
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def state(self) -> str:
        """Latest state reached (insertion order = record order)."""
        return next(reversed(self.state_ts)) if self.state_ts else "NIL"

    def is_terminal(self) -> bool:
        return any(s in self.state_ts for s in TERMINAL_STATES)

    # -- derived token-latency views (wall clock, from the state stamps)

    @property
    def ttft_s(self) -> Optional[float]:
        """Per-ATTEMPT time to first token.  A resumed stream's survivor
        row lacks the original admission stamp, so the cross-attempt
        truth (TTFT measured from FIRST admission) lives in
        ``stitch_request`` — this property stays the single-ring view."""
        if QUEUED in self.state_ts and DECODING in self.state_ts:
            return self.state_ts[DECODING] - self.state_ts[QUEUED]
        return None

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean per-token latency after the first token (terminal only)."""
        end = next((self.state_ts[s] for s in TERMINAL_STATES
                    if s in self.state_ts), None)
        if (end is None or DECODING not in self.state_ts
                or self.generated_tokens < 2):
            return None
        return (end - self.state_ts[DECODING]) / (self.generated_tokens - 1)

    @property
    def e2e_s(self) -> Optional[float]:
        end = next((self.state_ts[s] for s in TERMINAL_STATES
                    if s in self.state_ts), None)
        if end is None or QUEUED not in self.state_ts:
            return None
        return end - self.state_ts[QUEUED]

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["state"] = self.state
        d["ttft_s"] = self.ttft_s
        d["tpot_s"] = self.tpot_s
        d["e2e_s"] = self.e2e_s
        # Display form for `raytpu list requests`: accepted/drafted,
        # blank when the request never speculated (absent, not "0/0").
        d["spec"] = (f"{self.spec_accepted}/{self.spec_drafted}"
                     if self.spec_drafted else "")
        return d


class RequestEventBuffer:
    """Bounded per-engine ring; oldest *terminal* records are dropped
    first when over capacity (same eviction rule as TaskEventBuffer —
    live requests are the ones an operator is debugging)."""

    def __init__(self, engine: str, max_requests: int = 4096):
        self.engine = engine
        self._lock = threading.Lock()
        self._max = max_requests
        self._records: "collections.OrderedDict[str, RequestRecord]" = \
            collections.OrderedDict()
        self.num_dropped = 0

    def record(self, request_id: str, state: str, *,
               prompt_tokens: Optional[int] = None,
               generated_tokens: Optional[int] = None,
               slot: Optional[int] = None,
               num_pages: Optional[int] = None,
               terminal_cause: Optional[str] = None,
               attempt: Optional[int] = None,
               attempt_info: Optional[Dict[str, Any]] = None,
               prefix_hit: Optional[int] = None,
               adapter_id: Optional[str] = None,
               spec_drafted: Optional[int] = None,
               spec_accepted: Optional[int] = None) -> None:
        now = time.time()
        with self._lock:
            rec = self._records.get(request_id)
            if rec is None:
                rec = RequestRecord(request_id=request_id,
                                    engine=self.engine)
                self._records[request_id] = rec
                if len(self._records) > self._max:
                    self._evict_locked()
            if state in TERMINAL_STATES and rec.is_terminal():
                return  # first terminal verdict wins
            # First-entry wins: a state is ENTERED once; re-records (the
            # incremental-prefill path re-announces PREFILLING at its
            # final chunk, the failover path re-announces RETRYING per
            # attempt) keep the original stamp, so phase timestamps
            # stay monotone in record order.  Retry history rides the
            # attempt counter + attempts log instead of state_ts.
            rec.state_ts.setdefault(state, now)
            if attempt is not None:
                rec.attempt = attempt
            if attempt_info is not None:
                rec.attempts.append(dict(attempt_info, ts=now))
            if prompt_tokens is not None:
                rec.prompt_tokens = prompt_tokens
            if generated_tokens is not None:
                rec.generated_tokens = generated_tokens
            if slot is not None:
                rec.slot = slot
            if num_pages is not None:
                rec.num_pages = num_pages
            if terminal_cause is not None:
                rec.terminal_cause = terminal_cause
            if prefix_hit is not None:
                rec.prefix_hit = prefix_hit
            if adapter_id is not None:
                rec.adapter_id = adapter_id
            if spec_drafted is not None:
                rec.spec_drafted = spec_drafted
            if spec_accepted is not None:
                rec.spec_accepted = spec_accepted
        _flightrec_event(engine=self.engine, request_id=request_id,
                         state=state, attempt=attempt,
                         terminal_cause=terminal_cause)

    def update(self, request_id: str, *,
               generated_tokens: Optional[int] = None,
               spec_drafted: Optional[int] = None,
               spec_accepted: Optional[int] = None) -> None:
        """Touch live counters without a state transition (per-token /
        per-verify-round)."""
        with self._lock:
            rec = self._records.get(request_id)
            if rec is None:
                return
            if generated_tokens is not None:
                rec.generated_tokens = generated_tokens
            if spec_drafted is not None:
                rec.spec_drafted = spec_drafted
            if spec_accepted is not None:
                rec.spec_accepted = spec_accepted

    def _evict_locked(self) -> None:
        for key, rec in self._records.items():
            if rec.is_terminal():
                del self._records[key]
                self.num_dropped += 1
                return
        self._records.popitem(last=False)
        self.num_dropped += 1

    def row(self, request_id: str) -> Optional[Dict[str, Any]]:
        """One request's row dict (or None) without snapshotting the
        whole ring — the engine's per-terminal attribution path."""
        with self._lock:
            rec = self._records.get(request_id)
            if rec is None:
                return None
            rec = dataclasses.replace(
                rec, state_ts=dict(rec.state_ts),
                attempts=[dict(a) for a in rec.attempts])
        d = rec.to_dict()
        d["proc"] = "driver"
        return d

    def snapshot(self) -> List[RequestRecord]:
        with self._lock:
            return [dataclasses.replace(r, state_ts=dict(r.state_ts),
                                        attempts=[dict(a)
                                                  for a in r.attempts])
                    for r in self._records.values()]

    def counts_by_state(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.snapshot():
            out[rec.state] = out.get(rec.state, 0) + 1
        return out


def _flightrec_event(**fields) -> None:
    """Feed one ring transition into the always-on flight recorder
    (util/flight_recorder).  Guarded: the recorder must never be able
    to take the request plane down with it."""
    try:
        from ray_tpu_torch.util import flight_recorder
        flight_recorder.record("ring", **fields)
    except Exception:
        pass


# -- cross-attempt stitching ------------------------------------------------

def stitch_request(request_id: str,
                   rows: Optional[List[Dict[str, Any]]] = None,
                   ) -> Optional[Dict[str, Any]]:
    """Join every ring row carrying ``request_id`` (router and engine
    rows, across attempts) into one request-level view.

    A resumed stream (a failover retry, a migrated handoff) re-enters
    DECODING on a survivor whose ring lacks the original QUEUED stamp, so
    any single row's ``ttft_s``/``e2e_s`` measures the attempt, not the
    request.  Here TTFT and e2e are measured from FIRST admission:
    earliest QUEUED → earliest DECODING / latest genuine terminal
    (PREEMPTED ends an attempt, not the request, so it never ends the
    stitched timeline)."""
    if rows is None:
        rows = [r for r in snapshot_rows()
                if r.get("request_id") == request_id]
    if not rows:
        return None

    def min_ts(state: str) -> Optional[float]:
        ts = [r["state_ts"][state] for r in rows
              if state in r.get("state_ts", {})]
        return min(ts) if ts else None

    t_admitted = min_ts(QUEUED)
    t_first_token = min_ts(DECODING)
    genuine = (FINISHED, FAILED, CANCELLED, SHED)
    terminals = [(r["state_ts"][s], s) for r in rows for s in genuine
                 if s in r.get("state_ts", {})]
    t_terminal, state = (max(terminals) if terminals else (None, None))
    if state is None:
        # In flight (or only attempt-terminal PREEMPTED rows so far):
        # the most recently entered state across rows.
        entered = [(ts, s) for r in rows
                   for s, ts in r.get("state_ts", {}).items()]
        state = max(entered)[1] if entered else "NIL"
    router_rows = [r for r in rows
                   if str(r.get("engine", "")).startswith("router:")]
    # A router row counts the tokens DELIVERED across attempts; engine
    # rows count per-attempt generation (a replay regenerates).
    gen_pool = router_rows or rows
    return {
        "request_id": request_id,
        "state": state,
        "t_admitted": t_admitted,
        "t_first_token": t_first_token,
        "t_terminal": t_terminal,
        "ttft_s": (t_first_token - t_admitted
                   if t_admitted is not None and t_first_token is not None
                   else None),
        "e2e_s": (t_terminal - t_admitted
                  if t_admitted is not None and t_terminal is not None
                  else None),
        "attempts": max((int(r.get("attempt") or 0) for r in rows),
                        default=0),
        "prompt_tokens": max((int(r.get("prompt_tokens") or 0)
                              for r in rows), default=0),
        "generated_tokens": max((int(r.get("generated_tokens") or 0)
                                 for r in gen_pool), default=0),
        "rows": len(rows),
    }


# -- process-local registry -------------------------------------------------

_registry_lock = threading.Lock()
# engine id → buffer; weak so a ring lives exactly as long as its engine
# (the engine holds the strong ref) and dead engines drop out of listings.
_buffers: "weakref.WeakValueDictionary[str, RequestEventBuffer]" = \
    weakref.WeakValueDictionary()


def register(buffer: RequestEventBuffer) -> None:
    with _registry_lock:
        _buffers[buffer.engine] = buffer


def buffers() -> List[RequestEventBuffer]:
    with _registry_lock:
        return list(_buffers.values())


def snapshot_rows() -> List[Dict[str, Any]]:
    """Every known request of this process as a plain dict row."""
    rows: List[Dict[str, Any]] = []
    for buf in buffers():
        for rec in buf.snapshot():
            d = rec.to_dict()
            d["proc"] = "driver"
            rows.append(d)
    return rows


# -- request-id propagation -------------------------------------------------

_current_request_id: contextvars.ContextVar = contextvars.ContextVar(
    "raytpu_serve_request_id", default="")


def set_request_id(request_id: str):
    """Install the current request id; returns a reset token."""
    return _current_request_id.set(request_id)


def reset_request_id(token) -> None:
    _current_request_id.reset(token)


def get_request_id() -> str:
    return _current_request_id.get()
