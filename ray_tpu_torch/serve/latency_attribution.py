"""Per-request critical-path latency attribution, the waterfall (a copy
of ``ray_tpu/serve/latency_attribution.py`` over the port's request
ring, device plane and card peaks).

Joins the request-lifecycle ring (serve/request_events), the device
plane's program records (util/xprof) and the card's peaks
(utils/accelerator) into one per-request **waterfall** that partitions
end-to-end wall clock into named components:

    route           router admission → engine admission
    queue           engine admission → prefill start
    compile         overlap with first-dispatch walls (on the card: the
                    kernels' first-use builds and lazy CUDA init;
                    excluded from the control-plane share: the victim
                    request is not blamed for a cold start)
    prefill_device  device-cost estimate of the prompt's prefill
                    (clamped to the prefill phase wall)
    control_plane   the prefill-phase residual: dispatch, host-side
                    batching, scheduler overhead
    kv_transfer     decode-phase interludes where the stream was being
                    migrated to another replica (disagg handoff)
    retry_reprefill decode-phase interludes where a failed attempt was
                    being re-prefilled on a survivor
    decode_device   device-cost estimate of generated-token decode
    inter_step_gap  the decode-phase residual (host gaps between steps)

The partition is exact by construction: components always sum to the
stitched e2e wall.

Device estimates come from ``xprof.ProgramRecord.cost_steps`` (the token
count the recorded cost covers): per-token device seconds =
``max(flops/peak_flops, bytes/peak_bw) / cost_steps`` against
``accelerator.chip_spec()`` peaks.  The port's program costs are
analytic (the JAX package's come from XLA's ``cost_analysis()``), so the
device shares of the two packages' waterfalls are not held equal.  With
no cost numbers or no peaks the device components are 0 and the
residuals stay honest.

Terminal requests feed ``raytpu_serve_request_overhead_seconds
{component=...}`` and ``raytpu_serve_control_plane_share``;
``aggregate()`` is a benchmark's ``dispatch_overhead`` block.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.serve import request_events as reqev
from ray_tpu_torch.util import xprof

_TELEMETRY = None

COMPONENTS = ("route", "queue", "compile", "prefill_device",
              "control_plane", "kv_transfer", "retry_reprefill",
              "decode_device", "inter_step_gap")

# Program names whose recorded per-token device cost estimates each
# phase (first hit wins): unified engines dispatch serve.prefill /
# serve.decode, the mixed-batch engine dispatches serve.ragged for both
# (serve.ragged_spec is its speculative-verify variant — same shape,
# same per-token cost model).
_PREFILL_PROGRAMS = ("serve.prefill", "serve.ragged", "serve.ragged_spec")
_DECODE_PROGRAMS = ("serve.decode", "serve.ragged", "serve.ragged_spec")

_agg_lock = threading.Lock()
# (wall ts, waterfall dict) per observed terminal request — bounded;
# backs aggregate(since=) for a benchmark's legs.
_observed: "collections.deque" = collections.deque(maxlen=4096)
_cum = {"control_plane": 0.0, "e2e_ex_compile": 0.0}


def _telemetry():
    """Attribution metric singletons (re-registered on refetch — see
    serve/llm_engine._telemetry for the registry-clear rationale)."""
    global _TELEMETRY
    from ray_tpu_torch.util import metrics

    if _TELEMETRY is None:
        _TELEMETRY = {
            "overhead": metrics.Histogram(
                "raytpu_serve_request_overhead_seconds",
                "Per-request waterfall component seconds (route / queue "
                "/ compile / prefill_device / control_plane / "
                "kv_transfer / retry_reprefill / decode_device / "
                "inter_step_gap); components sum to the request's e2e.",
                boundaries=[0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                            0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                            30.0],
                tag_keys=("component",),
            ),
            "share": metrics.Gauge(
                "raytpu_serve_control_plane_share",
                "Cumulative control-plane share of request e2e wall "
                "(compile excluded) over this process's observed "
                "requests — the serving path's dispatch-overhead "
                "baseline.",
            ),
        }
    else:
        reg = metrics.registry()
        for m in _TELEMETRY.values():
            reg.register(m)
    return _TELEMETRY


def clear() -> None:
    """Reset the aggregation state (tests)."""
    with _agg_lock:
        _observed.clear()
        _cum["control_plane"] = 0.0
        _cum["e2e_ex_compile"] = 0.0


# -- device-cost + compile-window helpers -----------------------------------

def _chip_peaks() -> Tuple[Optional[float], Optional[float]]:
    try:
        from ray_tpu_torch.utils.accelerator import chip_spec
        spec = chip_spec()
        return spec.get("peak_flops"), spec.get("peak_hbm_bytes_per_s")
    except Exception:
        return None, None


def _per_token_device_s(program_names) -> float:
    """Analytic per-token device seconds for the first registered
    program in ``program_names`` with cost numbers: the roofline lower
    bound max(flops/peak_flops, bytes/peak_bw) over the tokens the
    recorded cost covers.  0.0 = no estimate (absent cost analysis)."""
    peak_flops, peak_bw = _chip_peaks()
    progs = xprof.programs()
    for name in program_names:
        rec = progs.get(name)
        if rec is None or not rec.cost_steps:
            continue
        bounds = []
        if rec.flops is not None and peak_flops:
            bounds.append(rec.flops / peak_flops)
        if rec.bytes_accessed is not None and peak_bw:
            bounds.append(rec.bytes_accessed / peak_bw)
        if bounds:
            return max(bounds) / rec.cost_steps
    return 0.0


def _overlap(windows: List[Tuple[float, float]],
             lo: float, hi: float) -> float:
    """Total coverage of [lo, hi] by the (possibly overlapping)
    windows, counted once."""
    if hi <= lo or not windows:
        return 0.0
    clipped = sorted((max(lo, a), min(hi, b)) for a, b in windows
                     if min(hi, b) > max(lo, a))
    total, cur_a, cur_b = 0.0, None, None
    for a, b in clipped:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _compile_windows() -> List[Tuple[float, float]]:
    return [(rec.compiled_at - rec.compile_time_s, rec.compiled_at)
            for rec in xprof.programs().values()
            if rec.compiled_at is not None
            and rec.compile_time_s is not None and rec.compile_time_s > 0]


# -- the waterfall join -----------------------------------------------------

def _min_state(rows: List[Dict[str, Any]], state: str) -> Optional[float]:
    ts = [r["state_ts"][state] for r in rows
          if state in r.get("state_ts", {})]
    return min(ts) if ts else None


def waterfall(request_id: str,
              rows: Optional[List[Dict[str, Any]]] = None,
              ) -> Optional[Dict[str, Any]]:
    """Join every ring row for ``request_id`` (router + engine rows,
    across processes and attempts) into one waterfall dict, or None
    when the request is unknown or not yet terminal."""
    if rows is None:
        rows = [r for r in reqev.snapshot_rows()
                if r.get("request_id") == request_id]
    if not rows:
        return None
    st = reqev.stitch_request(request_id, rows=rows)
    t0, t_end = st["t_admitted"], st["t_terminal"]
    if t0 is None or t_end is None or t_end < t0:
        return None
    t_end = max(t_end, t0)

    router_rows = [r for r in rows
                   if str(r.get("engine", "")).startswith("router:")]
    eng_rows = [r for r in rows if r not in router_rows] or rows

    def clamp(t, lo, hi):
        return min(max(t, lo), hi)

    q0 = clamp(_min_state(eng_rows, reqev.QUEUED) or t0, t0, t_end)
    t_dec0 = clamp(_min_state(eng_rows, reqev.DECODING) or t_end,
                   q0, t_end)
    t_pre = clamp(_min_state(eng_rows, reqev.PREFILLING) or t_dec0,
                  q0, t_dec0)

    comp = {c: 0.0 for c in COMPONENTS}
    comp["route"] = q0 - t0
    comp["queue"] = t_pre - q0

    cw = _compile_windows()
    compile_p = _overlap(cw, t_pre, t_dec0)
    compile_d = _overlap(cw, t_dec0, t_end)
    comp["compile"] = compile_p + compile_d

    prompt_tokens = st["prompt_tokens"]
    prefix_hit = max((int(r.get("prefix_hit") or 0) for r in eng_rows),
                     default=0)
    per_tok_pre = _per_token_device_s(_PREFILL_PROGRAMS)
    p_budget = max(0.0, (t_dec0 - t_pre) - compile_p)
    comp["prefill_device"] = min(
        per_tok_pre * max(0, prompt_tokens - prefix_hit), p_budget)
    comp["control_plane"] = p_budget - comp["prefill_device"]

    # Decode-phase interludes: a resumed attempt's engine row enters
    # QUEUED after the stream already produced tokens elsewhere —
    # [its QUEUED, its DECODING] is time the stream spent off-device
    # being handed over.  Classified kv_transfer when the router saw a
    # planned MIGRATING handoff, retry_reprefill otherwise (failover).
    d_budget = max(0.0, (t_end - t_dec0) - compile_d)
    migrated = any(reqev.MIGRATING in r.get("state_ts", {})
                   for r in router_rows)
    interlude_kind = "kv_transfer" if migrated else "retry_reprefill"
    for r in eng_rows:
        sts = r.get("state_ts", {})
        rq = sts.get(reqev.QUEUED)
        if rq is None or rq <= t_dec0:
            continue  # the first attempt, not a resume
        w0 = clamp(rq, t_dec0, t_end)
        w1 = clamp(sts.get(reqev.DECODING, t_end), w0, t_end)
        dur = max(0.0, (w1 - w0) - _overlap(cw, w0, w1))
        dur = min(dur, d_budget)
        comp[interlude_kind] += dur
        d_budget -= dur

    # Speculative decoding emits several tokens per verify step: the
    # device ran one step per ROUND for those, so the per-step cost
    # multiplies generated - accepted (each round = 1 step emitting
    # accepted_i + 1 tokens), keeping decode_device + inter_step_gap
    # an exact partition of the decode wall under multi-token bursts.
    spec_acc = max((int(r.get("spec_accepted") or 0) for r in eng_rows),
                   default=0)
    per_tok_dec = _per_token_device_s(_DECODE_PROGRAMS)
    comp["decode_device"] = min(
        per_tok_dec * max(0, st["generated_tokens"] - spec_acc),
        d_budget)
    comp["inter_step_gap"] = d_budget - comp["decode_device"]

    e2e = t_end - t0
    ex_compile = max(e2e - comp["compile"], 1e-12)
    return {
        "request_id": request_id,
        "state": st["state"],
        "t_start": t0,
        "t_end": t_end,
        "e2e_s": e2e,
        "ttft_s": st["ttft_s"],
        "attempts": st["attempts"],
        "prompt_tokens": prompt_tokens,
        "generated_tokens": st["generated_tokens"],
        "components": comp,
        "control_plane_share": comp["control_plane"] / ex_compile,
        "compile_excluded": comp["compile"] > 0.0,
        "procs": sorted({str(r.get("proc", "driver")) for r in rows}),
    }


# -- terminal observation (engine-side) + aggregation -----------------------

def observe_terminal(request_id: str,
                     rows: Optional[List[Dict[str, Any]]] = None,
                     ) -> Optional[Dict[str, Any]]:
    """Record a just-terminal request into the metric families and the
    aggregation window.  Called by the engine at terminal with its own
    ring row (no router row there: route = 0; ``waterfall`` over every
    row of the request gives the router-inclusive join)."""
    if rows is None:
        rows = [r for r in reqev.snapshot_rows()
                if r.get("request_id") == request_id]
    wf = waterfall(request_id, rows=rows)
    if wf is None:
        return None
    tm = _telemetry()
    for c in COMPONENTS:
        tm["overhead"].observe(wf["components"][c],
                               tags={"component": c})
    with _agg_lock:
        _observed.append((time.time(), wf))
        _cum["control_plane"] += wf["components"]["control_plane"]
        _cum["e2e_ex_compile"] += max(
            wf["e2e_s"] - wf["components"]["compile"], 0.0)
        share = (_cum["control_plane"]
                 / max(_cum["e2e_ex_compile"], 1e-12))
    tm["share"].set(share)
    return wf


def aggregate(since: float = 0.0) -> Optional[Dict[str, Any]]:
    """A benchmark leg's ``dispatch_overhead`` block: mean component
    seconds + aggregate control-plane share over requests observed at
    wall time >= ``since``.  None when nothing was observed (the block
    is absent-not-zero on legs that skip it)."""
    with _agg_lock:
        wfs = [wf for ts, wf in _observed if ts >= since]
    if not wfs:
        return None
    n = len(wfs)
    comps = {c: sum(wf["components"][c] for wf in wfs) / n
             for c in COMPONENTS}
    cp = sum(wf["components"]["control_plane"] for wf in wfs)
    ex = sum(max(wf["e2e_s"] - wf["components"]["compile"], 0.0)
             for wf in wfs)
    return {
        "requests": n,
        "components": comps,
        "control_plane_share": min(cp / max(ex, 1e-12), 1.0),
        "e2e_mean_s": sum(wf["e2e_s"] for wf in wfs) / n,
    }
