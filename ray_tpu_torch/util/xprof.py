"""The device plane: program cost records, roofline utilisation and the
shared device-memory gauges (the port of ``ray_tpu/util/xprof.py``'s
records, roofline and memory sampler; the family names are the JAX
package's, so the two expositions stay comparable).

  * ``record_program(name, flops=, bytes_accessed=)`` registers one named
    device program (``serve.prefill``, ``serve.decode``, ``serve.ragged``,
    ``train.step``, ...) with its cost per execution and its first call's
    wall.  The JAX package reads the numbers from XLA's
    ``cost_analysis()``; PyTorch has none, so the port counts them
    analytically from the model's shapes (``llama_costs`` and
    ``step_cost``): the weights and the head read once, the embedding
    rows gathered, the KV read and written, 2 x matmul params per token
    plus the attention's flops.
  * ``roofline()`` joins the records against the span walls their
    producers emit (``train.compute``, ``llm.decode``, ``llm.ragged``) and
    the card's peaks (``utils/accelerator.chip_spec``) into achieved vs
    peak utilisation gauges.
  * ``sample_device_memory()`` sets the per-device memory gauges from
    ``torch.cuda.memory_stats()``; on the CPU it records nothing.

A record without a number leaves its gauge absent, never zero.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

_TELEMETRY = None
_lock = threading.Lock()
_programs: "Dict[str, ProgramRecord]" = {}


@dataclasses.dataclass
class ProgramRecord:
    """One named device program and its static cost numbers."""

    name: str
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    compile_time_s: Optional[float] = None
    # Which tracer span carries this program's measured wall, and which
    # span attribute holds the number of device steps the wall covers
    # (None = the span is one step).
    span_name: Optional[str] = None
    steps_attr: Optional[str] = None
    # How many tokens (serving) or steps the cost numbers cover: the
    # per-token denominator of the waterfall's device estimates.  None =
    # unknown, no estimate.
    cost_steps: Optional[float] = None
    # Wall-clock END of the first call; with compile_time_s it bounds the
    # first-use window (kernel builds, lazy CUDA init) that a waterfall
    # excludes from the victim request's attribution.
    compiled_at: Optional[float] = None


def _telemetry():
    """Device-plane metric singletons (re-registered on refetch, so a
    registry clear() cannot drop them from the exposition)."""
    global _TELEMETRY
    from ray_tpu_torch.util import metrics

    if _TELEMETRY is None:
        _TELEMETRY = {
            "flops": metrics.Gauge(
                "raytpu_xla_program_flops",
                "Flop count of one named device program per execution "
                "(counted analytically from the model's shapes).",
                tag_keys=("program",),
            ),
            "bytes": metrics.Gauge(
                "raytpu_xla_program_bytes_accessed",
                "Bytes one named device program must move per execution "
                "(counted analytically: weights, KV read and written).",
                tag_keys=("program",),
            ),
            "compile": metrics.Counter(
                "raytpu_xla_compile_seconds_total",
                "First-call wall seconds (kernel builds and lazy device "
                "init on the card), by program.",
                tag_keys=("program",),
            ),
            "flops_util": metrics.Gauge(
                "raytpu_xla_roofline_flops_utilization",
                "Achieved flops / card peak flops for one program, from "
                "its cost over the measured span wall.",
                tag_keys=("program",),
            ),
            "bw_util": metrics.Gauge(
                "raytpu_xla_roofline_hbm_utilization",
                "Achieved memory bandwidth / card peak bandwidth for one "
                "program, from its cost over the measured span wall.",
                tag_keys=("program",),
            ),
            "hbm_in_use": metrics.Gauge(
                "raytpu_device_hbm_bytes_in_use",
                "Device memory currently allocated, by local device.",
                tag_keys=("device",),
            ),
            "hbm_peak": metrics.Gauge(
                "raytpu_device_hbm_bytes_peak",
                "Device memory high watermark, by local device.",
                tag_keys=("device",),
            ),
        }
    else:
        reg = metrics.registry()
        for m in _TELEMETRY.values():
            reg.register(m)
    return _TELEMETRY


def record_program(name: str, *, flops: Optional[float] = None,
                   bytes_accessed: Optional[float] = None,
                   compile_time_s: Optional[float] = None,
                   span_name: Optional[str] = None,
                   steps_attr: Optional[str] = None,
                   cost_steps: Optional[float] = None,
                   compiled_at: Optional[float] = None) -> ProgramRecord:
    """Register one named device program in the device plane.  Numbers
    given land as ``raytpu_xla_*`` samples; None stays absent.
    ``span_name``/``steps_attr`` name the tracer span that measures the
    program's wall, for the roofline join."""
    rec = ProgramRecord(
        name=name, flops=flops, bytes_accessed=bytes_accessed,
        compile_time_s=compile_time_s, span_name=span_name,
        steps_attr=steps_attr, cost_steps=cost_steps,
        compiled_at=(compiled_at if compiled_at is not None
                     else (time.time() if compile_time_s else None)))
    with _lock:
        _programs[name] = rec
    tm = _telemetry()
    tags = {"program": name}
    if flops is not None:
        tm["flops"].set(flops, tags=tags)
    if bytes_accessed is not None:
        tm["bytes"].set(bytes_accessed, tags=tags)
    if compile_time_s is not None and compile_time_s >= 0:
        tm["compile"].inc(compile_time_s, tags=tags)
    return rec


def programs() -> Dict[str, ProgramRecord]:
    with _lock:
        return dict(_programs)


def clear() -> None:
    """Drop every registered program (test isolation)."""
    with _lock:
        _programs.clear()


# -- analytic cost of a Llama step -------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelCost:
    """The static quantities of one model that a step's count needs."""

    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    dim: int
    vocab_size: int
    # Weights a token multiplies, over all layers (q, k, v, o, gate, up,
    # down); the head's dim x vocab is counted per logit row.
    matmul_params: int
    # Bytes a step reads of the parameter tree once: every leaf but the
    # embedding table (of which only the gathered rows are read; a tied
    # head reads the table whole, so it stays in).
    weight_bytes: int
    embed_row_bytes: int
    act_itemsize: int
    kv_itemsize: int
    kv_scales: bool


def _tree_bytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return int(tree.numel()) * int(tree.element_size())


def llama_costs(cfg: Any, params: Any) -> ModelCost:
    """A Llama config and its parameter tree (bf16, f32 or int8 leaves,
    fused or not) as a `ModelCost`."""
    import torch

    d, h, kvh, hd, m = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.mlp_dim)
    per_layer = d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * m
    emb = params["tok_embed"]
    emb_bytes = _tree_bytes(emb)
    tied = getattr(cfg, "tie_embeddings", False)
    kv_int8 = bool(getattr(cfg, "kv_int8", False))
    act = torch.empty((), dtype=cfg.dtype).element_size()
    return ModelCost(
        n_layers=cfg.n_layers, n_heads=h, n_kv_heads=kvh, head_dim=hd,
        dim=d, vocab_size=cfg.vocab_size,
        matmul_params=cfg.n_layers * per_layer,
        weight_bytes=_tree_bytes(params) - (0 if tied else emb_bytes),
        embed_row_bytes=emb_bytes // cfg.vocab_size,
        act_itemsize=act, kv_itemsize=1 if kv_int8 else act,
        kv_scales=kv_int8)


def step_cost(mc: ModelCost, rows: Sequence[Tuple[int, int]],
              logit_rows: int, page_size: int = 0) -> Tuple[float, float]:
    """(flops, bytes) of one forward step over ``rows``: (start, n) per
    sequence, whose n new tokens sit at positions start .. start + n - 1
    and attend causally to every earlier position.  A decode row is
    (length, 1), a prompt (0, true_len), a ragged row (row_start,
    row_len).  ``logit_rows`` rows go through the head.

    flops: 2 x matmul params per token, 2 x dim x vocab per logit row,
    and 4 x layers x heads x head_dim per (query, key) pair.  bytes: the
    weights once, one embedding row per token, each row's context read
    from the KV pool once, the new tokens' K and V written once (with
    an int8 pool's page scales, read and written a page at a time), and
    the logits written.  Activations between kernels are not counted."""
    mc_kv = mc.n_layers * mc.n_kv_heads * mc.head_dim * 2  # k and v
    tokens = pairs = ctx = pages = 0
    for start, n in rows:
        if n <= 0:
            continue
        tokens += n
        pairs += n * start + n * (n + 1) // 2
        ctx += start + n
        if mc.kv_scales and page_size:
            pages += -(-(start + n) // page_size)
    flops = (2.0 * mc.matmul_params * tokens
             + 2.0 * mc.dim * mc.vocab_size * logit_rows
             + 4.0 * mc.n_layers * mc.n_heads * mc.head_dim * pairs)
    kv_bytes = mc_kv * mc.kv_itemsize * (ctx + tokens)
    scale_bytes = 0
    if mc.kv_scales:
        scale_bytes = 2 * pages * mc.n_layers * mc.n_kv_heads * 2 * 4
    nbytes = (mc.weight_bytes + tokens * mc.embed_row_bytes + kv_bytes
              + scale_bytes + logit_rows * mc.vocab_size * mc.act_itemsize)
    return flops, float(nbytes)


def train_step_flops(n_params: int, tokens: int, n_layers: int,
                     n_heads: int, head_dim: int, seq_len: int,
                     causal: bool = True) -> float:
    """A training step's analytic flops: 6 x params x tokens (forward and
    backward through the weights, PERF.md's MFU count) plus the
    attention's 12 x layers x heads x head_dim x seq per token (forward
    q.k and p.v, twice that backward; halved when causal)."""
    attn = 12.0 * n_layers * n_heads * head_dim * seq_len * tokens
    return 6.0 * n_params * tokens + (attn / 2 if causal else attn)


# -- roofline attribution ---------------------------------------------------

def _program_walls() -> Dict[str, List[float]]:
    """Per-program measured per-step walls, joined from the tracer's
    finished spans via each record's (span_name, steps_attr)."""
    from ray_tpu_torch.util import tracing

    by_span: Dict[str, List[ProgramRecord]] = {}
    for rec in programs().values():
        if rec.span_name:
            by_span.setdefault(rec.span_name, []).append(rec)
    walls: Dict[str, List[float]] = {}
    for s in tracing.finished_spans():
        recs = by_span.get(s.get("name"))
        if not recs or s.get("end") is None:
            continue
        if (s.get("attributes") or {}).get("compile"):
            continue  # the first call's wall (builds, lazy init), not a step
        dur = s["end"] - s["start"]
        if dur <= 0:
            continue
        for rec in recs:
            steps = 1.0
            if rec.steps_attr:
                try:
                    steps = float(
                        s.get("attributes", {}).get(rec.steps_attr, 1.0))
                except (TypeError, ValueError):
                    steps = 1.0
            walls.setdefault(rec.name, []).append(dur / max(1.0, steps))
    return walls


def roofline() -> Dict[str, Dict[str, Any]]:
    """Per-program achieved vs peak attribution.

    For each registered program with a measured span wall:

        achieved_flops/s = cost flops / median per-step wall
        flops_util       = achieved_flops/s / card peak flops
        achieved_bytes/s = cost bytes / median per-step wall
        hbm_util         = achieved_bytes/s / card peak bandwidth

    Peaks come from ``utils/accelerator.chip_spec()``: the nominal CPU
    envelope on the CPU, none for a card without an entry (then the rows
    carry no utilisation).  Results land in the
    ``raytpu_xla_roofline_*`` gauges and come back as a dict."""
    from ray_tpu_torch.utils.accelerator import chip_spec

    spec = chip_spec()
    peak_flops = spec.get("peak_flops")
    peak_bw = spec.get("peak_hbm_bytes_per_s")
    walls = _program_walls()
    tm = _telemetry()
    out: Dict[str, Dict[str, Any]] = {}
    for name, rec in programs().items():
        ws = sorted(walls.get(name, ()))
        if not ws:
            continue
        wall = ws[len(ws) // 2]  # median
        row: Dict[str, Any] = {"wall_s_per_step": wall,
                               "chip": spec.get("chip", "?")}
        tags = {"program": name}
        if rec.flops is not None:
            row["achieved_flops_per_s"] = rec.flops / wall
            if peak_flops:
                row["peak_flops"] = peak_flops
                row["flops_utilization"] = rec.flops / wall / peak_flops
                tm["flops_util"].set(row["flops_utilization"], tags=tags)
        if rec.bytes_accessed is not None:
            row["achieved_hbm_bytes_per_s"] = rec.bytes_accessed / wall
            if peak_bw:
                row["peak_hbm_bytes_per_s"] = peak_bw
                row["hbm_utilization"] = (rec.bytes_accessed / wall
                                          / peak_bw)
                tm["bw_util"].set(row["hbm_utilization"], tags=tags)
        out[name] = row
    return out


# -- device memory ----------------------------------------------------------

def sample_device_memory() -> Dict[str, Dict[str, int]]:
    """Per-card allocator watermarks → the shared gauges, tagged
    ``device="cuda:i"``: ``allocated_bytes.all.current`` and ``.peak``
    of ``torch.cuda.memory_stats``.  Returns what it set; on the CPU (no
    card, or CUDA never initialised) it records nothing."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    tm = _telemetry()
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats or "allocated_bytes.all.current" not in stats:
            continue
        tags = {"device": f"cuda:{i}"}
        cur = int(stats["allocated_bytes.all.current"])
        peak = int(stats["allocated_bytes.all.peak"])
        tm["hbm_in_use"].set(cur, tags=tags)
        tm["hbm_peak"].set(peak, tags=tags)
        out[tags["device"]] = {"in_use": cur, "peak": peak}
    return out
