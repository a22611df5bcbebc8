"""Continuous-batching LLM engine (port of
``ray_tpu/serve/llm_engine.py``): on the paged KV cache (bucketed,
chunked and ragged) or on a dense one.

Design, as in the JAX engine:

  * a fixed number of KV-cache **slots** (the batch dimension of every
    decode step); requests claim a slot and pages of the pool, and
    decode advances ALL active slots together;
  * **bucketed prefill**: prompts are right-padded to power-of-two
    buckets rounded up to a page multiple; one batched prefill per
    bucket group, padded to a power-of-two row count with copies of the
    last row (their samples never reach ``cur``);
  * sampling happens on the device; the last sampled token per slot
    (``cur``) and the lengths stay device-resident between decode
    chunks, and each chunk's tokens reach the host in ONE non-blocking
    copy (pinned memory + a CUDA event), not one per step;
  * admission interleaves with decode between chunks.

The engine owns the page pool and mutates it in place (the paged
kernels write into it).  With a dense ``EngineAdapter``
(``llama_adapter``) the cache is max_slots rows of max_seq_len that
keep their lengths on the device: admission takes up to 8 requests into
one prefill padded to the group's largest bucket, decode advances the
active rows, a released slot only returns to the free list, and neither
the ragged step nor chunked prefill applies, as in the JAX engine.  One
loop thread does all device work; client threads only submit, cancel
and read their streams.

Two more scheduling modes, as in the JAX engine:

  * **chunked prefill** (``prefill_chunk > 0``): prompts longer than a
    chunk prefill one chunk per loop iteration, interleaved with decode
    chunks, so a long prompt never blocks running streams for its whole
    prefill;
  * **the ragged unified step** (``ragged_batching=True``): every
    request claims its slot and pages at admission, and ONE device step
    packs a decode row for every running stream first, then prompt
    chunks until ``token_budget`` tokens are packed (kernels K4 and K5).
    Its per-step host arrays reach the card in one pinned, non-blocking
    copy.

int8 KV pools (``LlamaConfig.kv_int8``) serve on the bucketed and the
ragged path (kernels K1/K3 and K4/K6 with page scales); chunked prefill
outside the ragged step refuses them, as in the JAX engine.

**The prefix cache** (``prefix_cache=True``, ragged only): finished
requests donate their full KV pages to a radix tree
(``serve/prefix_index.py``); admission borrows the longest cached prefix
and the ragged prefill resumes at the hit boundary; an exact full-prompt
hit copies the deepest shared page before the last token is re-run;
admission pressure evicts unreferenced cached pages.

**Speculative decoding** (``spec_decode=True``, ragged only): a draft
model (the target itself when none is given) keeps its own paged pool;
each uncontended dispatch drafts up to ``spec_k`` tokens for every idle
greedy base-model slot, and the step carries them as one verify row of
k+1 tokens whose logits at every position come back with the step.  The
host accepts the longest matching prefix plus the bonus token and
rewinds the slot's length to the accept boundary; rejected positions
are overwritten before anything attends to them.  The base ragged step
is untouched, so spec-off output is the oracle.

**Multi-tenant LoRA** (a ``LlamaConfig.lora`` model, ragged only):
``submit(adapter_id=)`` borrows the adapter's pages from a paged pool
(``serve/adapter_pool.py``) for the request's lifetime, and steps that
hold an adapter row run the segmented-LoRA variant of the ragged step
(``ops/segmented_lora.py``); steps without one run the base step.

**The planes**, as in the JAX engine, all on host mirrors (no device
read of their own):

  * telemetry under the ``raytpu_serve_*`` names (``_telemetry``),
    updated where the loop already stands: at dispatch and at fetch;
  * the request ring (``serve/request_events.py``): QUEUED →
    PREFILLING → DECODING → FINISHED / CANCELLED / PREEMPTED / FAILED,
    or SHED at admission;
  * SLO accounting and goodput (``EngineConfig.slo``) and shedding
    (``shed_queue_age_s``: a ``ShedError`` while the oldest queued
    request is older than the budget);
  * ``drain()``: admission stops, and after a grace window every
    request still running ends with a ``PreemptedError`` carrying its
    continuation (prompt and the tokens its stream delivered);
  * the invariant audit (``doctor()``, ``serve/audit.py``): O(slots)
    conservation sums after slot releases, full walks on demand, on
    idle, after a drain evicts and at stop;
  * ``LLMServer``, the ready-made deployment class.

**KV page migration** (``prefix_cache=True``, as in the JAX engine):
``migration_lease`` pins a cached prefix against eviction,
``migration_export`` serialises its pages (``serve/kv_transfer.py``'s
wire format, exact or int8), ``migration_release`` drops the lease,
``migration_ingest`` verifies a transfer's hashes and scatters its pages
into free pages of the local pool and trie, and ``export_hot_prefixes``
runs lease, export and release over the trie's hot paths.  The verbs are
queued to the loop thread, which owns the pool: export gathers exactly
the leased pages on the engine's stream and copies them to the host
once; ingest copies from pinned memory on the same stream, so the
scatter lands after every step already queued.

**The latency waterfall and the device plane**: the first dispatch of
each program (``serve.prefill``, ``serve.decode``, ``serve.ragged``,
``serve.ragged_spec``, ``serve.spec_draft``, ``serve.spec_chain``)
registers its analytic cost with ``util/xprof.py``, and every terminal
request's waterfall (``serve/latency_attribution.py``) partitions its
e2e wall into queue, compile, device and host components.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.core.exceptions import PreemptedError, ShedError
from ray_tpu_torch.ops.ragged_paged_attention import pack_ragged_batch
from ray_tpu_torch.serve import audit as _audit
from ray_tpu_torch.serve import request_events as _reqev
from ray_tpu_torch.util import tracing

log = logging.getLogger(__name__)

_TELEMETRY = None

# A decode step slower than this many times its running median is a
# stall worth a warning.
STALL_FACTOR = 5.0


def _telemetry():
    """Engine metric singletons (created on first engine construction,
    re-registered on later fetches so a registry clear() cannot drop the
    serving plane from the exposition), merged with the KV migration's,
    the adapter pool's, the waterfall's, the flight recorder's and the
    doctor's families, so each family is exported from engine
    construction on, before its first event."""
    global _TELEMETRY
    from ray_tpu_torch.util import metrics

    if _TELEMETRY is None:
        _TELEMETRY = {
            "ttft": metrics.Histogram(
                "raytpu_serve_ttft_seconds",
                "Time from submit to first generated token, per request.",
                boundaries=[0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                            1.0, 2.5, 5.0, 10.0, 30.0],
            ),
            "tpot": metrics.Histogram(
                "raytpu_serve_tpot_seconds",
                "Mean per-output-token latency after the first token, "
                "per request.",
                boundaries=[0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                            0.05, 0.1, 0.25, 1.0],
            ),
            "queue_depth": metrics.Gauge(
                "raytpu_serve_queue_depth",
                "Requests admitted nowhere yet: waiting queue + paged "
                "backlog, sampled at dispatch time.",
            ),
            "batch_size": metrics.Histogram(
                "raytpu_serve_decode_batch_size",
                "Active slots per decode dispatch (continuous-batch "
                "occupancy).",
                boundaries=[1, 2, 4, 8, 16, 32, 64],
            ),
            "step_wall": metrics.Gauge(
                "raytpu_serve_step_wall_seconds",
                "High-water mark of per-decode-step wall time "
                "(dispatch-to-fetch wall of a chunk / steps in it — an "
                "upper bound on device step time including pipeline "
                "queueing).",
            ),
            "queue_age": metrics.Gauge(
                "raytpu_serve_admission_queue_age_seconds",
                "Age of the oldest request still waiting for admission "
                "(waiting queue + paged backlog), sampled at dispatch "
                "time.  Climbing age with stable depth = stalled "
                "admission, not load.",
            ),
            "itl": metrics.Histogram(
                "raytpu_serve_request_itl_seconds",
                "Worst client-observed inter-token gap within a "
                "finished request (the hiccup a streaming reader "
                "actually sees; mean gap is TPOT).  A speculative "
                "verify round emits several tokens in one burst: the "
                "round's wall gap is divided by the burst size so the "
                "histogram stays an exact per-token partition.",
                boundaries=[0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                            0.1, 0.25, 1.0, 5.0],
            ),
            "spec_rounds": metrics.Counter(
                "raytpu_serve_spec_rounds_total",
                "Speculative verify rounds completed (one draft+verify "
                "cycle of up to spec_k tokens per round).",
            ),
            "spec_drafted": metrics.Counter(
                "raytpu_serve_spec_drafted_tokens_total",
                "Tokens drafted by the draft model across verify "
                "rounds.",
            ),
            "spec_accepted": metrics.Counter(
                "raytpu_serve_spec_accepted_tokens_total",
                "Drafted tokens the target model accepted (the free "
                "bonus token each round emits on top is not counted).",
            ),
            "spec_accept_ratio": metrics.Gauge(
                "raytpu_serve_spec_accept_ratio",
                "Cumulative accepted/drafted token ratio over this "
                "engine's speculative verify rounds.",
            ),
            "slo": metrics.Counter(
                "raytpu_serve_request_slo_total",
                "Terminal requests by SLO outcome: met only when the "
                "request FINISHED inside every bound of "
                "EngineConfig.slo (no slo config = every finish is "
                "met); failed/cancelled always miss.",
                tag_keys=("outcome",),
            ),
            "terminal": metrics.Counter(
                "raytpu_serve_request_terminal_total",
                "Requests reaching a terminal state, by state "
                "(FINISHED / FAILED / CANCELLED / SHED).",
                tag_keys=("state",),
            ),
            "arrived": metrics.Counter(
                "raytpu_serve_requests_arrived_total",
                "Requests submitted to this engine (admitted, shed or "
                "rejected alike) — the raw arrival process.  Its rate "
                "and slope are the LEADING load signal: they move "
                "before the queue forms.",
            ),
            "shed": metrics.Counter(
                "raytpu_serve_shed_total",
                "Requests refused at admission because the queue was "
                "already older than the SLO budget "
                "(EngineConfig.shed_queue_age_s) — clean fast-fail "
                "backpressure instead of a guaranteed-late answer.",
            ),
            "goodput": metrics.Gauge(
                "raytpu_serve_goodput_ratio",
                "Tokens from SLO-met requests over all tokens of "
                "terminal requests — goodput vs raw throughput.",
            ),
            "step_tokens": metrics.Counter(
                "raytpu_serve_step_tokens_total",
                "Tokens dispatched to the device, split by phase "
                "(prefill vs decode).  Attributes step wall time: a "
                "rising prefill share explains decode-stream TPOT "
                "regressions without any per-request change.",
                tag_keys=("phase",),
            ),
            "kv_pages_free": metrics.Gauge(
                "raytpu_serve_kv_pages_free",
                "Free pages in the paged KV pool (neither slot-mapped "
                "nor held by the prefix cache).",
            ),
            "kv_pages_cached": metrics.Gauge(
                "raytpu_serve_kv_pages_cached",
                "Pages owned by the prefix cache (0 when the cache is "
                "disabled).  free + cached + slot-owned = pool.",
            ),
            "prefix_requests": metrics.Counter(
                "raytpu_serve_prefix_requests_total",
                "Admitted requests by prefix-cache outcome (hit = at "
                "least one full page reused).",
                tag_keys=("outcome",),
            ),
            "prefix_hit_ratio": metrics.Gauge(
                "raytpu_serve_prefix_hit_ratio",
                "Cumulative prompt tokens served from the prefix cache "
                "over all prompt tokens admitted (token-weighted hit "
                "ratio).",
            ),
            "prefix_hit_depth": metrics.Histogram(
                "raytpu_serve_prefix_hit_depth_tokens",
                "Per-request prefix-cache hit depth in tokens (0 = "
                "cold prefill) — joins with TTFT for "
                "TTFT-by-hit-depth.",
                boundaries=[1, 16, 32, 64, 128, 256, 512, 1024, 2048,
                            4096],
            ),
            "prefix_cached_pages": metrics.Gauge(
                "raytpu_serve_prefix_cached_pages",
                "Pages currently held by the radix-tree prefix index.",
            ),
            "prefix_evicted": metrics.Counter(
                "raytpu_serve_prefix_evicted_pages_total",
                "Cache pages evicted (refcount-0 LRU) under admission "
                "pressure.",
            ),
        }
    else:
        reg = metrics.registry()
        for m in _TELEMETRY.values():
            reg.register(m)
    from ray_tpu_torch.serve import adapter_pool as _apool
    from ray_tpu_torch.serve import kv_transfer as _kvt
    from ray_tpu_torch.serve import latency_attribution as _lat
    from ray_tpu_torch.util import doctor as _doc
    from ray_tpu_torch.util import flight_recorder as _frec

    out = dict(_TELEMETRY)
    out.update(_kvt._telemetry())
    out.update(_apool._telemetry())
    out.update(_lat._telemetry())
    out.update({f"frec_{k}": v for k, v in _frec._telemetry().items()})
    out.update({f"doctor_{k}": v for k, v in _doc._telemetry().items()})
    return out


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency objectives; a None bound is unconstrained.  A
    request is SLO-met only when it FINISHED inside every set bound:
    failed, cancelled and preempted requests always miss."""

    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    e2e_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    max_seq_len: int = 1024
    min_prefill_bucket: int = 32
    max_new_tokens_default: int = 128
    eos_id: Optional[int] = None
    # Paged KV cache.  num_pages=0 sizes the pool for full occupancy
    # (slots × max_seq_len); smaller pools oversubscribe and requests
    # queue when no pages are free.
    page_size: int = 64
    num_pages: int = 0
    # Decode this many steps per host round trip; chunk sizes are the
    # powers of two ≤ this.
    decode_chunk: int = 16
    # Chunked prefill: prompts longer than this prefill in chunks of
    # this many tokens between decode chunks (0 = one bucketed prefill).
    prefill_chunk: int = 0
    # Latency objectives driving the SLO met/missed counters and the
    # goodput gauge (None = every finished request counts as met).
    slo: Optional[SLO] = None
    # Overload shedding: refuse (ShedError) new submissions while the
    # oldest unadmitted request has already waited longer than this
    # (None = never shed).  The natural setting is slo.e2e_s.
    shed_queue_age_s: Optional[float] = None
    # Ragged unified step (K4 + K5): one device step packs decode rows
    # and prompt chunks into token_budget tokens (0 = max_slots +
    # max(prefill_chunk, page_size)).
    ragged_batching: bool = False
    token_budget: int = 0
    # Radix-tree prefix cache over the page pool (requires
    # ragged_batching: prefill-from-offset rides the ragged step's
    # per-row start).
    prefix_cache: bool = False
    # Multi-tenant LoRA (ragged only, with an adapter whose model config
    # sets lora): the adapter pool's pages (0 = room for 4 adapters),
    # their size in f32 elements, the distinct adapters one step may
    # gather (the null adapter included), and int8 pages.
    adapter_pool_pages: int = 0
    adapter_page_elems: int = 8192
    max_batch_adapters: int = 8
    adapter_int8: bool = False
    # Speculative decoding (ragged only): drafts per verify row, the
    # draft pool's pages (0 = max_slots x pages per sequence), and the
    # cooldown: when the acceptance EMA falls below spec_cold_accept,
    # spec_cooldown_rounds dispatches decode plainly.
    spec_decode: bool = False
    spec_k: int = 4
    spec_draft_pages: int = 0
    spec_cold_accept: float = 0.2
    spec_cooldown_rounds: int = 32

    def buckets(self) -> List[int]:
        out, b = [], self.min_prefill_bucket
        while b < self.max_seq_len:
            out.append(b)
            b *= 2
        out.append(self.max_seq_len)
        return out


@dataclasses.dataclass(frozen=True)
class EngineAdapter:
    """Model plug for the dense cache (max_slots rows of max_seq_len):

    init_cache(slots, max_len, device) -> cache dict with an int32
        "length"[slots] on the device
    prefill_slot(params, tokens[S], true_len, slot, cache)
        -> (logits[V], cache)
    decode_slots(params, tokens[slots], active[slots], cache)
        -> (logits[slots, V], cache)
    prefill_batch(params, tokens[K,S], true_lens[K], slots[K], cache)
        -> (logits[K,V], cache)  (one [K, S] forward; without it the
        engine prefills the rows one prefill_slot call at a time)
    model_cfg: the model's config, from which the device plane counts
        each program's cost (None: the records carry no cost)
    """

    init_cache: Callable[[int, int, torch.device], Any]
    prefill_slot: Callable[..., Tuple[torch.Tensor, Any]]
    decode_slots: Callable[..., Tuple[torch.Tensor, Any]]
    prefill_batch: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    model_cfg: Any = None


def llama_adapter(cfg) -> EngineAdapter:
    """The dense-cache plug for a Llama model (``models/llama.py``'s
    ``init_kv_cache``, ``prefill_slot``, ``decode_slots`` and
    ``prefill_batch``)."""
    from ray_tpu_torch.models import llama

    return EngineAdapter(
        init_cache=lambda slots, max_len, device: llama.init_kv_cache(
            cfg, slots, max_len, device),
        prefill_slot=lambda params, tokens, true_len, slot, cache:
            llama.prefill_slot(params, tokens, true_len, slot, cfg, cache),
        decode_slots=lambda params, tokens, active, cache:
            llama.decode_slots(params, tokens, active, cfg, cache),
        prefill_batch=lambda params, tokens, true_lens, slots, cache:
            llama.prefill_batch(params, tokens, true_lens, slots, cfg,
                                cache),
        model_cfg=cfg,
    )


@dataclasses.dataclass(frozen=True)
class PagedEngineAdapter:
    """Model plug for the paged (block-table) cache:

    init_cache(num_pages, page_size, device) -> cache dict (the engine
        tracks lengths host-side and device-side)
    prefill_slot(params, tokens[S], true_len, pages[S/page], cache)
        -> (logits[V], cache)
    prefill_batch(params, tokens[K,S], true_lens[K], pages_rows[K,S/page],
        cache) -> (logits[K,V], cache)
    decode_slots(params, tokens[slots], active, block_tables, lengths,
        cache) -> (logits[slots, V], cache, new_lengths)
    prefill_chunk(params, tokens[K,C], start[K], chunk_lens[K],
        pages_rows[K,maxp], cache) -> (logits[K,V], cache)  (chunked
        prefill; None disables it)
    ragged_step(params, tokens[T], tok_pos[T], row_slot, row_start,
        row_len, row_off, block_tables, cache) -> (logits[R,V], cache)
        (the unified step; needed by ragged_batching)
    copy_page(cache, src, dst) -> cache  (duplicate one physical page,
        scales included; needed by prefix_cache)
    ragged_step_lora(params, tokens, tok_pos, row_slot, row_start,
        row_len, row_off, block_tables, cache, pool, page_table,
        tok_adapter) -> (logits[R,V], cache)  (the unified step with
        per-token segmented adapter deltas gathered from the pool)
    make_adapter_pool(engine_config, device) -> AdapterPool  (both set
        iff the model config enables LoRA)
    ragged_step_verify(params, tokens, ..., cache, logit_idx) ->
        (logits[R,V], verify_logits[Tv,V], cache)  (the unified step with
        extra logits at the flat-buffer positions logit_idx, the first R
        rows equal to ragged_step's; needed by spec_decode)
    ragged_step_lora_verify(..., pool, page_table, tok_adapter,
        logit_idx)  (both at once: verify rows beside adapter rows)
    model_cfg: the model's config, from which the device plane counts
        each program's cost (None: the records carry no cost)
    """

    init_cache: Callable[[int, int, torch.device], Any]
    prefill_slot: Callable[..., Tuple[torch.Tensor, Any]]
    decode_slots: Callable[..., Tuple[torch.Tensor, Any, torch.Tensor]]
    prefill_batch: Callable[..., Tuple[torch.Tensor, Any]]
    prefill_chunk: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    ragged_step: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    copy_page: Optional[Callable[[Any, int, int], Any]] = None
    ragged_step_lora: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    make_adapter_pool: Optional[Callable[[Any, torch.device], Any]] = None
    ragged_step_verify: Optional[
        Callable[..., Tuple[torch.Tensor, torch.Tensor, Any]]] = None
    ragged_step_lora_verify: Optional[
        Callable[..., Tuple[torch.Tensor, torch.Tensor, Any]]] = None
    model_cfg: Any = None


def llama_paged_adapter(cfg, lora_loader=None) -> PagedEngineAdapter:
    """``lora_loader`` (adapter_id -> factor tree or flat f32 vector)
    feeds the adapter pool when ``cfg.lora`` is set; None uses the seeded
    loader (``segmented_lora.default_adapter_loader``)."""
    from ray_tpu_torch.models import llama

    def ragged(params, tokens, tok_pos, row_slot, row_start, row_len,
               row_off, bt, cache, **kw):
        return llama.ragged_step_paged(params, tokens, tok_pos, row_slot,
                                       row_start, row_len, row_off, bt, cfg,
                                       cache, **kw)

    lora_fields: Dict[str, Any] = {}
    if getattr(cfg, "lora", None) is not None:
        from ray_tpu_torch.ops import segmented_lora as _sl
        from ray_tpu_torch.serve.adapter_pool import AdapterPool

        def lora_arg(pool, page_table, tok_adapter):
            # One cast to the compute dtype a step: each layer's delta
            # would otherwise cast its own factors (the same values).
            flat = _sl.gather_adapter_flat(pool, page_table).to(cfg.dtype)
            stacks = _sl.gather_adapter_stacks(flat, cfg, cfg.lora)
            return (stacks, tok_adapter.long(), cfg.lora.scale)

        def ragged_step_lora(params, tokens, tok_pos, row_slot, row_start,
                             row_len, row_off, bt, cache, pool, page_table,
                             tok_adapter):
            return ragged(params, tokens, tok_pos, row_slot, row_start,
                          row_len, row_off, bt, cache,
                          lora=lora_arg(pool, page_table, tok_adapter))

        def ragged_step_lora_verify(params, tokens, tok_pos, row_slot,
                                    row_start, row_len, row_off, bt, cache,
                                    pool, page_table, tok_adapter,
                                    logit_idx):
            return ragged(params, tokens, tok_pos, row_slot, row_start,
                          row_len, row_off, bt, cache,
                          lora=lora_arg(pool, page_table, tok_adapter),
                          logit_idx=logit_idx)

        lora_fields = {
            "ragged_step_lora": ragged_step_lora,
            "ragged_step_lora_verify": ragged_step_lora_verify,
            "make_adapter_pool": lambda ecfg, device: AdapterPool(
                cfg, cfg.lora, num_pages=ecfg.adapter_pool_pages,
                page_elems=ecfg.adapter_page_elems,
                max_batch_adapters=ecfg.max_batch_adapters,
                int8=ecfg.adapter_int8, loader=lora_loader, device=device),
        }

    return PagedEngineAdapter(
        **lora_fields,
        init_cache=lambda num_pages, page, device: llama.init_paged_cache(
            cfg, num_pages, page, device),
        prefill_slot=lambda params, tokens, true_len, pages, cache:
            llama.prefill_slot_paged(params, tokens, true_len, pages, cfg,
                                     cache),
        decode_slots=lambda params, tokens, active, bt, lens, cache:
            llama.decode_slots_paged(params, tokens, active, bt, lens, cfg,
                                     cache),
        prefill_batch=lambda params, tokens, true_lens, pages_rows, cache:
            llama.prefill_batch_paged(params, tokens, true_lens, pages_rows,
                                      cfg, cache),
        prefill_chunk=lambda params, tokens, start, chunk_lens, pages_rows,
        cache:
            llama.prefill_chunk_paged(params, tokens, start, chunk_lens,
                                      pages_rows, cfg, cache),
        ragged_step=ragged,
        ragged_step_verify=lambda params, tokens, tok_pos, row_slot,
        row_start, row_len, row_off, bt, cache, logit_idx: ragged(
            params, tokens, tok_pos, row_slot, row_start, row_len, row_off,
            bt, cache, logit_idx=logit_idx),
        copy_page=llama.copy_page_paged,
        model_cfg=cfg,
    )


def _sample(logits: torch.Tensor, temperature: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [..., V], temperature [...] — greedy at temp 0, categorical
    otherwise (Gumbel-max with ``generator``'s noise); on the device.
    With no generator every row is greedy."""
    greedy = logits.argmax(dim=-1)
    if generator is None:
        return greedy.to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    scaled = logits / temperature.clamp(min=1e-6)[..., None]
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int
    temperature: float
    stream: "queue.Queue"
    req_id: int
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    # Telemetry: the submitter's span context (None when tracing is
    # off) and the admission stamp splitting queue wait from prefill in
    # the request's span tree.
    trace_ctx: Optional[Dict[str, str]] = None
    admitted_at: Optional[float] = None
    # End-to-end id labelling the ring, spans and log lines; the
    # inter-token gap is tracked incrementally by _emit.
    request_id: str = ""
    last_token_at: Optional[float] = None
    max_itl_s: float = 0.0
    # Prompt tokens served from the prefix cache (0 = cold prefill).
    prefix_hit: int = 0
    # LoRA adapter this request decodes with ("" = the base model).
    adapter_id: str = ""
    # Speculative tokens drafted for this request and accepted of them.
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


_DONE = object()


class CompletionStream:
    """Client view of one request: iterate tokens as they generate."""

    def __init__(self, req: Request, engine: "Optional[LLMEngine]" = None):
        self._req = req
        self._engine = engine
        self._done = threading.Event()

    @property
    def request_id(self) -> str:
        return self._req.request_id

    def cancel(self) -> None:
        """Ask the engine to cancel this request (idempotent).  The
        stream still ends normally with the tokens emitted so far."""
        if self._engine is not None:
            self._engine.cancel(self._req.request_id)

    def __iter__(self):
        while not self._done.is_set():
            item = self._req.stream.get()
            if item is _DONE:
                self._done.set()
                return
            if isinstance(item, BaseException):
                self._done.set()
                raise item
            yield item

    def result(self, timeout_s: Optional[float] = None) -> List[int]:
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while not self._done.is_set():
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                item = self._req.stream.get(timeout=remaining)
            except queue.Empty:
                raise TimeoutError(
                    f"generation not finished within {timeout_s}s "
                    f"({len(self._req.tokens)} tokens so far)") from None
            if item is _DONE:
                self._done.set()
            elif isinstance(item, BaseException):
                self._done.set()
                raise item
        return list(self._req.tokens)

    @property
    def metrics(self) -> Dict[str, Any]:
        r = self._req
        return {"ttft_s": r.ttft_s,
                "total_s": (None if r.finished_at is None
                            else r.finished_at - r.submitted_at),
                "num_tokens": len(r.tokens)}


class LLMServer:
    """Ready-made serving deployment hosting an LLMEngine (the JAX
    package's ``LLMServer``, unified role).

    Request payload: {"tokens": [...], "max_new_tokens"?: int,
    "temperature"?: float, "request_id"?: str, "adapter_id"?: str} →
    {"tokens": [...], "metrics": {...}, "request_id": str}.
    ``param_loader`` runs where the server is built, so weights never
    travel as arguments; ``device`` is the engine's (the card unless the
    caller asks for the CPU).

    The JAX server also reads the shard group and the disaggregated
    role that ``ray_tpu.serve`` installs around a replica; no context of
    ``ray_tpu.serve`` is readable from the port, so this server hosts one
    engine on one device in the unified role, and the adapter id comes
    from the payload only.  Of the migration plane it serves the two
    replica-to-replica targets, ``ingest_kv_transfer`` and
    ``export_hot_prefixes``; the handoff stream and the prefix pull need
    Serve handles.
    """

    def __init__(self, model_cfg: Any, engine_cfg: EngineConfig,
                 param_loader: Callable[[], Any], *,
                 adapter_factory: Optional[Callable[[Any], Union[
                     EngineAdapter, PagedEngineAdapter]]] = None,
                 draft_param_loader: Optional[Callable[[], Any]] = None,
                 draft_model_cfg: Any = None, device: DeviceLike = None):
        make_adapter = adapter_factory or llama_adapter
        # The draft model of speculative decoding loads here like the
        # target; no loader + spec_decode=True = the engine self-drafts.
        draft_params = (draft_param_loader()
                        if draft_param_loader is not None else None)
        draft_adapter = None
        if draft_params is not None:
            draft_adapter = make_adapter(draft_model_cfg
                                         if draft_model_cfg is not None
                                         else model_cfg)
        self.engine = LLMEngine(
            param_loader(), make_adapter(model_cfg), engine_cfg,
            device=device, draft_params=draft_params,
            draft_adapter=draft_adapter)

    def _submit(self, payload: Dict[str, Any]) -> "CompletionStream":
        return self.engine.submit(
            payload["tokens"],
            max_new_tokens=payload.get("max_new_tokens"),
            temperature=payload.get("temperature", 0.0),
            request_id=payload.get("request_id"),
            adapter_id=payload.get("adapter_id") or "")

    def __call__(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._submit(payload)
        tokens = stream.result()
        return {"tokens": tokens, "metrics": stream.metrics,
                "request_id": stream.request_id}

    def stream(self, payload: Dict[str, Any]):
        """Streaming entry: yields tokens as the engine generates them.
        A preemption surfaces as PreemptedError AFTER every generated
        token has been yielded, so the caller knows the exact delivered
        prefix."""
        yield from self._submit(payload)

    def drain(self, grace_s: float = 5.0) -> int:
        """Preemption notice: drain the engine (stop admitting, evict
        running requests with continuations)."""
        return self.engine.drain(grace_s)

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def pressure(self) -> Dict[str, Any]:
        """SLO-pressure signals for an autoscaling policy: the admission
        queue's age (the leading overload signal), the cumulative goodput
        ratio (None until a request is terminal) and the cumulative
        arrival count."""
        return {"queue_age_s": self.engine.admission_queue_age(),
                "goodput": self.engine.goodput_ratio(),
                "arrivals": self.engine.arrivals_total()}

    def prefix_summary(self) -> Optional[Dict[str, Any]]:
        """Prefix-cache routing summary (None when the cache is off)."""
        return self.engine.prefix_summary()

    def adapter_summary(self) -> Optional[Dict[str, Any]]:
        """Resident-adapter routing summary (None when LoRA multiplexing
        is off)."""
        return self.engine.adapter_summary()

    def doctor(self, deep: bool = True) -> Dict[str, Any]:
        """Run one invariant audit over the hosted engine and return its
        report."""
        return self.engine.doctor(deep=deep)

    def ingest_kv_transfer(self, transfer: Dict[str, Any]) -> int:
        """Land one migration transfer (``kv_transfer`` wire format, made
        by either package) in the hosted engine's pool; returns the pages
        ingested."""
        return self.engine.migration_ingest(transfer)

    def export_hot_prefixes(self, max_pages: int = 256,
                            mode: str = "int8") -> List[Dict[str, Any]]:
        """Serialise the hosted engine's hot cached prefixes (prefix
        migration, source side)."""
        return self.engine.export_hot_prefixes(max_pages=max_pages,
                                               mode=mode)

    def check_health(self) -> None:
        if self.engine._stopped.is_set():
            raise RuntimeError("engine stopped")
        # A critical violation (a corrupted page partition or refcount)
        # from the most recent audit fails the health verdict: such a
        # pool can silently corrupt streams.  Leaks (error) alert
        # through metrics instead.
        critical = self.engine._auditor.last_critical()
        if critical:
            v = critical[0]
            raise RuntimeError(
                f"doctor: invariant {v['check']} violated "
                f"({v['subject']}: expected {v['expected']!r}, got "
                f"{v['actual']!r}; {len(critical)} critical total)")


@dataclasses.dataclass
class _InFlight:
    """A dispatched prefill or decode whose tokens are on their way to
    the host: ``host`` is filled once ``event`` (None on the CPU) has
    completed."""

    kind: str  # "prefill", "decode", "pfchunk" (a marker) or "ragged"
    host: torch.Tensor
    event: Optional[Any]
    chunk: int
    participants: List[Tuple[Any, ...]]
    t_disp: float  # dispatch stamp: the stall watermark's wall starts here
    # Where the dispatch's host enqueue began: the device may run the
    # step's kernels while the host still enqueues them, so a step's
    # device time lies between this stamp and the fetch.
    t_start: float = 0.0

    @property
    def carries_first_tokens(self) -> bool:
        return self.kind == "prefill" or (
            self.kind == "ragged"
            and any(part[0] == "first" for part in self.participants))


def _holds_qdict(tree: Any) -> bool:
    """Whether a param tree holds an int8 ``{"q", "scale"}`` leaf."""
    if not isinstance(tree, dict):
        return False
    if set(tree) == {"q", "scale"}:
        return True
    return any(_holds_qdict(v) for v in tree.values())


_ENGINE_IDS = itertools.count()


def _tensor_device(tree: Any) -> Optional[torch.device]:
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _tensor_device(v)
            if dev is not None:
                return dev
        return None
    return tree.device if isinstance(tree, torch.Tensor) else None


class LLMEngine:
    """Continuous-batching scheduler around paged prefill/decode, with
    chunked prefill or the ragged unified step when configured, or
    around dense prefill/decode with an ``EngineAdapter``."""

    # Dispatched-but-unemitted entries: enough to keep the device busy
    # while the host processes tokens; budget gating bounds run-ahead.
    _PIPELINE_DEPTH = 6

    def __init__(self, params: Any,
                 adapter: Union[EngineAdapter, PagedEngineAdapter],
                 config: EngineConfig, *, seed: int = 0,
                 device: DeviceLike = None, draft_params: Any = None,
                 draft_adapter: Optional[PagedEngineAdapter] = None):
        """``draft_params``/``draft_adapter``: the draft model of
        speculative decoding (``config.spec_decode``); with no draft
        params the target drafts for itself."""
        self.config = config
        self.adapter = adapter
        self.device = resolve_device(device)
        for tree in (params, draft_params):
            pdev = _tensor_device(tree)
            if pdev is not None and pdev.type != self.device.type:
                raise ValueError(f"params live on {pdev}, engine device is "
                                 f"{self.device}")
        self._params = params
        page = config.page_size
        self._paged = isinstance(adapter, PagedEngineAdapter)
        if not self._paged and _holds_qdict(params):
            # The JAX dense path dequantises only in its prefills: its
            # decode fails on an int8 tree.
            raise ValueError(
                "the dense EngineAdapter (llama_adapter) does not serve int8 "
                "weights: its decode step takes plain weights, as in the JAX "
                "package; serve a quantised tree with llama_paged_adapter")
        self._ragged = bool(config.ragged_batching)
        if self._ragged:
            if not self._paged or adapter.ragged_step is None:
                raise ValueError("EngineConfig.ragged_batching requires a "
                                 "PagedEngineAdapter with ragged_step")
            self._token_budget = config.token_budget or (
                config.max_slots + max(config.prefill_chunk, page))
            if self._token_budget < config.max_slots + 1:
                raise ValueError(
                    "token_budget must leave room for a prefill chunk "
                    f"beside {config.max_slots} decode rows")
        else:
            if config.spec_decode:
                raise ValueError(
                    "EngineConfig.spec_decode requires ragged_batching=True "
                    "(verify rows are k-token rows of the unified ragged "
                    "step)")
            if getattr(adapter, "make_adapter_pool", None) is not None:
                raise ValueError(
                    "LoRA multiplexing requires ragged_batching (the "
                    "segmented adapter matmul rides the unified step)")
        # A dense adapter has no chunked prefill: prefill_chunk > 0 does
        # not chunk, as in the JAX engine.
        self._chunked = (self._paged and not self._ragged
                         and config.prefill_chunk > 0
                         and adapter.prefill_chunk is not None)
        if self._paged:
            self._maxp = -(-config.max_seq_len // page)
            self._num_pages = (config.num_pages
                               or config.max_slots * self._maxp)
            self._cache = adapter.init_cache(self._num_pages, page,
                                             self.device)
        else:
            # max_slots rows of max_seq_len positions; the cache keeps
            # each row's length on the device.
            self._cache = adapter.init_cache(config.max_slots,
                                             config.max_seq_len, self.device)
        if (isinstance(self._cache, dict) and "k_scale" in self._cache
                and config.prefill_chunk > 0 and not self._ragged):
            # The ragged append works a page at a time and CAN grow page
            # scales, so int8 KV with chunked prompts is a restriction
            # of the chunked interleave only.
            raise ValueError(
                "kv_int8 pools do not support chunked prefill "
                "(per-token page scatters cannot grow page scales "
                "on the gather path) — set "
                "EngineConfig.prefill_chunk=0, enable "
                "ragged_batching, or serve with bf16 KV")
        self._free_pages = (list(range(self._num_pages)) if self._paged
                            else [])
        self._slot_pages: Dict[int, List[int]] = {}
        # Radix-tree prefix cache: finished requests donate full pages
        # to the trie; slots borrow them at admission (_slot_borrowed
        # tracks which block-table entries the cache owns, so release
        # never returns them to the free list).
        self._prefix = None
        self._slot_borrowed: Dict[int, List[int]] = {}
        if config.prefix_cache:
            if not self._ragged:
                raise ValueError(
                    "prefix_cache requires ragged_batching=True "
                    "(prefill-from-offset rides the ragged step's "
                    "per-row start descriptor)")
            if adapter.copy_page is None:
                raise ValueError(
                    "prefix_cache requires an adapter with "
                    "copy_page (the COW split of a shared page)")
            from ray_tpu_torch.serve.prefix_index import PrefixIndex
            self._prefix = PrefixIndex(page)
        # KV page migration (serve/kv_transfer): clients queue lease,
        # export, release and ingest ops here and the loop thread, the
        # only one that touches the pool, runs them (_process_migrations).
        # _mig_staging holds each ingest's pinned host buffer with an
        # event recorded after its copy: the buffer lives until the event
        # has completed.
        self._mig_lock = threading.Lock()
        self._mig_ops: List[Dict[str, Any]] = []
        self._mig_leases: Dict[str, Dict[str, Any]] = {}
        self._mig_lease_ids = itertools.count(1)
        self._mig_counts = {"pages_out": 0, "pages_in": 0,
                            "bytes_out": 0, "bytes_in": 0}
        self._mig_staging: List[Tuple[torch.Tensor, Any]] = []
        self._prefix_hit_tokens = 0
        self._prefix_prompt_tokens = 0
        # LoRA: the engine owns the adapter pool; a slot's borrow ("" =
        # base model) is released with the slot on every terminal path.
        self._adapters = None
        self._slot_adapter: Dict[int, str] = {}
        if self._ragged and adapter.make_adapter_pool is not None:
            if adapter.ragged_step_lora is None:
                raise ValueError("adapter exposes make_adapter_pool without "
                                 "ragged_step_lora")
            self._adapters = adapter.make_adapter_pool(config, self.device)
        # Unallocated block-table entries hold the OOB sentinel
        # (num_pages, the scratch page): never read by attention, and a
        # slot decoded past its allocation writes only scratch.
        self._bt = (np.full((config.max_slots, self._maxp), self._num_pages,
                            np.int32) if self._paged else None)
        # Host mirror of every slot's cache length (the dense cache's
        # ``length`` on a dense adapter).
        self._lens = np.zeros((config.max_slots,), np.int32)
        self._backlog: List[Request] = []  # admitted-but-no-pages
        self._waiting: "queue.Queue[Request]" = queue.Queue()
        self._slot_req: Dict[int, Request] = {}
        self._free_slots = list(range(config.max_slots))
        # Last sampled token and length per slot live ON DEVICE: the
        # next decode chunk reads them without a host round trip.
        self._cur_dev = torch.zeros((config.max_slots,), dtype=torch.int32,
                                    device=self.device)
        self._lens_dev: Optional[torch.Tensor] = None
        self._temps = np.zeros((config.max_slots,), np.float32)
        self._pending: "deque[_InFlight]" = deque()
        self._inflight_tokens: Dict[int, int] = {}  # slot → undelivered
        self._req_counter = itertools.count()
        # Cumulative arrivals (every submit, shed included), a plain int
        # so pressure() reads it without the registry.
        self._arrived = 0
        self._stopped = threading.Event()
        # drain(): _draining stops admission, _drain_evict tells the loop
        # to preempt whatever still runs.  Both are one-way latches.
        self._draining = threading.Event()
        self._drain_evict = threading.Event()
        self._preempted_count = 0
        self._work = threading.Event()
        self._steps = 0
        self._tokens_out = 0
        self._admitting: List[Request] = []
        self._tm = _telemetry()
        self._update_page_gauges()
        # The request ring: the engine holds the only strong ref (the
        # module registry is weak).
        self._engine_id = f"torch-engine-{next(_ENGINE_IDS)}"
        self._ring = _reqev.RequestEventBuffer(self._engine_id)
        _reqev.register(self._ring)
        # The audit plane: doctor() enqueues audit ops like cancels, and
        # the loop, which owns every audited registry, runs them.
        self._auditor = _audit.EngineAuditor(self)
        self._audit_lock = threading.Lock()
        self._audit_ops: List[Dict[str, Any]] = []
        self._crashed = False
        self._drain_audited = False
        self._cancel_lock = threading.Lock()
        self._cancels: set = set()
        # Goodput: tokens of SLO-met requests vs all terminal tokens.
        self._good_tokens = 0
        self._terminal_tokens = 0
        self._step_walls: deque = deque(maxlen=64)  # recent s/step
        self._step_wall_hw = 0.0  # watermark mirrored to the gauge
        self._stall_events = 0  # steps past STALL_FACTOR x median
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        ladder, k = [], max(1, config.decode_chunk)
        while k >= 1:
            ladder.append(k)
            k //= 2
        self._chunk_ladder = tuple(ladder)
        # Per-slot control tensors on the device, rebuilt only when
        # admission or a finish changed them.
        self._state_dirty = True
        self._active_dev = self._temps_dev = self._bt_dev = None
        self._any_sampled = False
        # Incremental prefills (chunked and ragged modes): {"req", "slot",
        # "pos" = prompt tokens already prefilled}.  Their slot and pages
        # are claimed; the request joins _slot_req with its last chunk.
        self._prefilling: List[Dict[str, Any]] = []
        self._step_tokens = {"decode": 0, "prefill": 0}
        self._mixed_steps = 0  # ragged steps with decode AND prompt rows
        # The device plane: programs whose first dispatch registered
        # their analytic cost (util/xprof), and the model's static cost
        # quantities (None when the adapter names no model config).
        self._xprof_recorded: set = set()
        self._costs = self._model_costs(adapter, params)
        self._spec_on = False
        if config.spec_decode:
            self._init_spec(draft_params, draft_adapter)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine-torch")
        self._thread.start()

    def _init_spec(self, draft_params: Any,
                   draft_adapter: Optional[PagedEngineAdapter]) -> None:
        """The speculative-decoding plane: a second paged pool for the
        draft model's KV (same allocator discipline, its own OOB scratch
        page) and the draft and verify calls.  The base ragged step is
        untouched: steps without verify rows call it as before, so
        spec-off output is the oracle by construction."""
        config, adapter = self.config, self.adapter
        if adapter.ragged_step_verify is None:
            raise ValueError(
                "EngineConfig.spec_decode requires an adapter with "
                "ragged_step_verify (the unified step with extra verify "
                "logits)")
        if self._adapters is not None \
                and adapter.ragged_step_lora_verify is None:
            # A verify row can share a step with another slot's LoRA row.
            raise ValueError("spec_decode with LoRA multiplexing requires "
                             "an adapter with ragged_step_lora_verify")
        if draft_params is None:
            # Self-draft: every draft is accepted, so this drives the
            # verify path (and the parity tests) rather than saving steps.
            draft_params, draft_adapter = self._params, None
        da = draft_adapter or adapter
        if da.ragged_step is None:
            raise ValueError(
                "spec_decode draft adapter must provide ragged_step")
        self._draft_adapter = da
        self._draft_params = draft_params
        self._draft_costs = self._model_costs(da, draft_params)
        self._draft_pages = (config.spec_draft_pages
                             or config.max_slots * self._maxp)
        self._draft_cache = da.init_cache(self._draft_pages,
                                          config.page_size, self.device)
        self._draft_free = list(range(self._draft_pages))
        self._draft_slot_pages: Dict[int, List[int]] = {}
        self._draft_bt = np.full((config.max_slots, self._maxp),
                                 self._draft_pages, np.int32)
        # Tokens of each slot's sequence already fed to the draft KV.
        self._draft_fed: Dict[int, int] = {}
        # A slot with a verify round in flight is fully idle (its length
        # only moves at the accept boundary, on the host at fetch); a
        # slot whose device cur went stale after a verify round re-seeds
        # it through a host-token decode row.
        self._spec_inflight: set = set()
        self._spec_stale_cur: set = set()
        self._spec_ema = 1.0
        self._spec_cooldown = 0
        self._spec_rounds = 0
        self._spec_drafted_total = 0
        self._spec_accepted_total = 0
        self._spec_cooldowns = 0
        self._spec_draft_steps = 0
        self._step_tokens["spec_draft"] = 0
        self._step_tokens["spec_verify"] = 0
        # Static width of the verify-logit gather: flat-buffer positions
        # of every verify row's k+1 candidate tokens, padded with 0.
        self._spec_tv = min(self._token_budget,
                            config.max_slots * (config.spec_k + 1))
        self._spec_on = True

    # -- the device plane (util/xprof) --------------------------------------

    @staticmethod
    def _model_costs(adapter: Any, params: Any) -> Optional[Any]:
        """The model's static cost quantities for the device plane's
        analytic counts, or None when the adapter names no model
        config."""
        cfg = getattr(adapter, "model_cfg", None)
        if cfg is None:
            return None
        from ray_tpu_torch.util import xprof
        try:
            return xprof.llama_costs(cfg, params)
        except Exception:
            log.exception("device plane: no cost model for this adapter's "
                          "config; program records carry no cost")
            return None

    def _first_dispatch(self, name: str) -> Optional[float]:
        """Wall-clock start of ``name``'s first dispatch (None for every
        later one, which passes straight through)."""
        return None if name in self._xprof_recorded else time.time()

    def _register_program(self, name: str, t0: float, *, span_name: str,
                          rows, logit_rows: int,
                          steps_attr: Optional[str] = None,
                          cost_steps: Optional[float] = None,
                          costs: Any = None) -> None:
        """After the first dispatch of ``name``: register its analytic cost
        (``rows`` = (start, new tokens) per sequence row, ``logit_rows``
        rows through the head) and the dispatch's wall, which on the card
        holds the kernels' first-use builds and lazy CUDA init.  That wall
        is also a span tagged compile=True, which the roofline skips and
        the waterfall charges to ``compile``, as in the JAX engine."""
        t1 = time.time()
        self._xprof_recorded.add(name)
        mc = self._costs if costs is None else costs
        try:
            from ray_tpu_torch.util import xprof
            flops = nbytes = None
            if mc is not None:
                flops, nbytes = xprof.step_cost(mc, rows, logit_rows,
                                                self.config.page_size)
            xprof.record_program(name, flops=flops, bytes_accessed=nbytes,
                                 compile_time_s=t1 - t0, span_name=span_name,
                                 steps_attr=steps_attr, cost_steps=cost_steps,
                                 compiled_at=t1)
        except Exception:
            log.exception("device plane: recording program %s failed", name)
        if tracing.is_enabled():
            tracing.record_span(span_name, t0, t1,
                                attributes={"compile": True, "program": name})

    # -- client API --------------------------------------------------------

    def submit(self, prompt: List[int], *,
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               request_id: Optional[str] = None,
               adapter_id: str = "") -> CompletionStream:
        """``adapter_id`` names a LoRA adapter of the engine's pool (a
        LoRA model only; "" = the base model).  A draining engine raises
        PreemptedError with an empty continuation; with
        ``shed_queue_age_s`` set, an admission queue older than it raises
        ShedError."""
        if self._stopped.is_set():
            raise RuntimeError("engine is stopped (shut down or crashed)")
        if self._draining.is_set():
            # The failover signal of a mid-stream preemption, with an
            # empty generated prefix.
            raise PreemptedError(
                "engine is draining: not admitting new requests",
                continuation={"prompt": list(prompt), "tokens": [],
                              "temperature": float(temperature),
                              "request_id": request_id or "",
                              "adapter_id": adapter_id})
        # Count the arrival before any admission decision: the signal
        # must see offered load, not just what survived shedding.
        self._arrived += 1
        self._tm["arrived"].inc()
        shed_after = self.config.shed_queue_age_s
        if shed_after is not None:
            age = self._admission_queue_age()
            if age > shed_after:
                # A request queued now waits behind work already over
                # the budget: record the SHED terminal (no attempt ever
                # runs) and fail fast.  Goodput is untouched.
                rid = (request_id or _reqev.get_request_id()
                       or f"{self._engine_id}-r{next(self._req_counter)}")
                self._ring.record(rid, _reqev.SHED,
                                  prompt_tokens=len(prompt),
                                  terminal_cause="ShedError",
                                  adapter_id=adapter_id)
                self._tm["shed"].inc()
                self._tm["terminal"].inc(tags={"state": _reqev.SHED})
                try:
                    from ray_tpu_torch.util import flight_recorder
                    flight_recorder.trigger("shed", request_id=rid,
                                            queue_age_s=age)
                except Exception:
                    pass  # the verdict must not depend on the recorder
                raise ShedError(queue_age_s=age)
        if adapter_id and self._adapters is None:
            raise ValueError(
                f"request carries adapter_id {adapter_id!r} but this "
                "engine has no adapter pool (serve a model whose "
                "LlamaConfig sets lora)")
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) >= self.config.max_seq_len:
            raise ValueError(f"prompt length {len(prompt)} >= max_seq_len "
                             f"{self.config.max_seq_len}")
        req = Request(
            prompt=list(prompt),
            max_new_tokens=(max_new_tokens
                            or self.config.max_new_tokens_default),
            temperature=float(temperature), stream=queue.Queue(),
            req_id=next(self._req_counter),
            trace_ctx=(tracing.capture_context()
                       if tracing.is_enabled() else None),
            adapter_id=adapter_id)
        # Explicit id > the ambient one (the request_id contextvar) >
        # a local mint.
        req.request_id = (request_id or _reqev.get_request_id()
                          or f"{self._engine_id}-r{req.req_id}")
        # Reject requests the page pool can NEVER satisfy — they would
        # otherwise wedge admission head-of-line forever.
        if self._paged and self._pages_needed(req) > self._num_pages:
            raise ValueError(
                f"request needs {self._pages_needed(req)} pages "
                f"({len(prompt)}+{req.max_new_tokens} tokens, page "
                f"{self.config.page_size}) but the pool has only "
                f"{self._num_pages}")
        self._ring.record(req.request_id, _reqev.QUEUED,
                          prompt_tokens=len(req.prompt),
                          adapter_id=req.adapter_id)
        self._waiting.put(req)
        self._work.set()
        return CompletionStream(req, self)

    def generate(self, prompt: List[int], **kw) -> List[int]:
        return self.submit(prompt, **kw).result()

    def cancel(self, request_id: str) -> None:
        """Cancel a request by id (idempotent; unknown or terminal ids
        are a no-op).  The loop resolves it: the slot and pages are
        released and the stream ends with the tokens so far."""
        if self._stopped.is_set():
            return
        with self._cancel_lock:
            self._cancels.add(request_id)
        self._work.set()

    def drain(self, grace_s: float = 5.0) -> int:
        """Preemption-aware drain: stop admitting, give requests already
        in a slot ``grace_s`` to finish, then evict the survivors with a
        PREEMPTED terminal whose PreemptedError carries the continuation
        (prompt, the tokens its stream delivered, sampling state):
        everything another engine needs to resume with one re-prefill.
        Requests that never reached a slot are evicted at once.
        Blocking, callable from any thread, idempotent; returns the
        number of requests preempted so far."""
        if self._stopped.is_set():
            return self._preempted_count
        self._draining.set()
        self._work.set()
        deadline = time.monotonic() + max(0.0, grace_s)
        while (time.monotonic() < deadline
               and not self._stopped.is_set()
               and not self._drain_idle()):
            time.sleep(0.01)
        self._drain_evict.set()
        self._work.set()
        # The loop owns slot and page state: give it a bounded window to
        # run the eviction pass.
        evict_deadline = time.monotonic() + 5.0
        while (time.monotonic() < evict_deadline
               and not self._stopped.is_set()
               and not self._drain_idle()):
            time.sleep(0.01)
        return self._preempted_count

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def _drain_idle(self) -> bool:
        """No request the drain still has to account for."""
        if self._slot_req or not self._waiting.empty() or self._admitting:
            return False
        if self._prefilling or (self._paged and self._backlog):
            return False
        return True

    @property
    def engine_id(self) -> str:
        """Stable name of this engine's request ring (the ``engine`` key
        of its rows)."""
        return self._engine_id

    def stats(self) -> Dict[str, Any]:
        out = {"engine": self._engine_id,
               "device": str(self.device),
               "active_slots": self.config.max_slots - len(self._free_slots),
               "waiting": self._waiting.qsize() + len(self._backlog),
               "prefilling": len(self._prefilling),
               "steps": self._steps,
               "tokens_out": self._tokens_out,
               "stall_events": self._stall_events,
               "requests": self._ring.counts_by_state(),
               # Tokens dispatched to the device by phase (prefill
               # padding rows included), and ragged steps that packed
               # decode rows beside prompt tokens.
               "step_tokens": dict(self._step_tokens),
               "mixed_steps": self._mixed_steps}
        if self._paged:
            out["kv_pages_free"] = len(self._free_pages)
            out["kv_pages_cached"] = (self._prefix.cached_pages
                                      if self._prefix else 0)
        if self._prefix is not None:
            pstats = self._prefix.stats()
            pstats["hit_tokens"] = self._prefix_hit_tokens
            pstats["prompt_tokens"] = self._prefix_prompt_tokens
            out["prefix"] = pstats
            out["kv_migration"] = dict(self._mig_counts)
        if self._adapters is not None:
            out["adapters"] = self._adapters.stats()
        if self._spec_on:
            out["spec"] = {
                "rounds": self._spec_rounds,
                "drafted_tokens": self._spec_drafted_total,
                "accepted_tokens": self._spec_accepted_total,
                "accept_ratio": (
                    self._spec_accepted_total / self._spec_drafted_total
                    if self._spec_drafted_total else None),
                "cooldowns": self._spec_cooldowns,
                "draft_steps": self._spec_draft_steps,
                "ema": self._spec_ema,
                "k": self.config.spec_k,
                "draft_pages_free": len(self._draft_free),
            }
        return out

    def admission_queue_age(self) -> float:
        """Seconds the oldest still-unadmitted request has waited (0.0
        when nothing waits): the leading overload signal."""
        return self._admission_queue_age()

    def goodput_ratio(self) -> Optional[float]:
        """Cumulative goodput ratio (tokens of SLO-met requests over all
        terminal tokens, the raytpu_serve_goodput_ratio gauge), or None
        before any request reached a terminal state."""
        if not self._terminal_tokens:
            return None
        return self._good_tokens / self._terminal_tokens

    def arrivals_total(self) -> int:
        """Cumulative requests submitted (shed included)."""
        return self._arrived

    def prefix_summary(self, max_entries: int = 256) -> Optional[dict]:
        """Compact routing summary of the prefix cache ({"page": …,
        "hashes": [chained CRC32 path hashes]}), or None when the cache
        is off."""
        if self._prefix is None:
            return None
        return self._prefix.summary(max_entries)

    def adapter_summary(self) -> Optional[dict]:
        """Compact routing summary of the adapter pool ({"adapters":
        [resident ids]}), or None when LoRA multiplexing is off."""
        if self._adapters is None:
            return None
        return self._adapters.summary()

    def doctor(self, deep: bool = True,
               timeout_s: float = 30.0) -> Dict[str, Any]:
        """Run one invariant audit pass (serve/audit) and return its
        report.  While the loop runs, the audit is queued for it to run
        between dispatches (the loop owns every audited registry); once
        the engine has stopped it runs inline.  ``deep=False`` runs only
        the O(slots) conservation tier."""
        if self._stopped.is_set() or not self._thread.is_alive():
            # Let a stopping loop finish its final audit and clean-up
            # first, so the inline walk never races it.
            self._thread.join(timeout=5.0)
            return self._auditor.run(deep=deep)
        op: Dict[str, Any] = {"deep": bool(deep),
                              "done": threading.Event(),
                              "result": None, "error": None}
        with self._audit_lock:
            self._audit_ops.append(op)
        self._work.set()
        if not op["done"].wait(timeout_s):
            with self._audit_lock:
                try:
                    self._audit_ops.remove(op)
                except ValueError:
                    pass
            if not op["done"].is_set():
                if self._stopped.is_set():
                    self._thread.join(timeout=5.0)
                    return self._auditor.run(deep=deep)
                raise TimeoutError(
                    f"doctor audit not serviced within {timeout_s}s")
        if op["error"] is not None:
            raise op["error"]
        return op["result"]

    def doctor_report(self) -> Optional[Dict[str, Any]]:
        """The most recent audit report without running a new pass (None
        before the first audit)."""
        return self._auditor.last_report

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Stop the loop and wait for it; requests still running end
        with a RuntimeError."""
        self._stopped.set()
        self._work.set()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=timeout_s)

    # -- admission ---------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.config.buckets():
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket")

    def _paged_bucket_for(self, n: int) -> int:
        """Prefill bucket rounded UP to a page multiple: the paged
        prefill writes whole pages."""
        page = self.config.page_size
        return -(-self._bucket_for(n) // page) * page

    def _pages_needed(self, req: Request) -> int:
        """Pages covering max(prefill bucket, prompt+max_new)."""
        page = self.config.page_size
        bucket = self._paged_bucket_for(len(req.prompt))
        return min(max(bucket // page,
                       -(-(len(req.prompt) + req.max_new_tokens) // page)),
                   self._maxp)

    def _alloc_slot_pages(self, req: Request,
                          need: Optional[int] = None) -> Optional[int]:
        """Claim a slot + its pages; the block-table row gets the pages
        then the OOB sentinel.  None when the pool can't cover it."""
        if need is None:
            need = self._pages_needed(req)
        if not self._free_slots:
            return None
        if len(self._free_pages) < need and self._prefix is not None:
            # Admission pressure evicts refcount-0 LRU cache pages
            # BEFORE the request queues: the cache borrows idle pool
            # capacity, it never competes with admission for it.
            freed = self._prefix.evict(need - len(self._free_pages))
            if freed:
                self._free_pages.extend(freed)
                self._tm["prefix_evicted"].inc(len(freed))
        if len(self._free_pages) < need:
            return None
        slot = self._free_slots.pop()
        pages = [self._free_pages.pop() for _ in range(need)]
        self._slot_pages[slot] = pages
        row = np.full((self._maxp,), self._num_pages, np.int32)
        row[: len(pages)] = pages
        self._bt[slot] = row
        self._update_page_gauges()
        return slot

    def _admit_slot_for(self, req: Request) -> Optional[Tuple[int, int]]:
        """Claim a slot + pages, borrowing the longest cached prefix
        when the prefix cache is on.  Returns (slot, start) — the
        ragged prefill resumes at ``start`` instead of 0 — or None
        under slot/page pressure (every borrowed ref released).

        Only FULL pages are cached and prefill resumes at the hit
        boundary, so shared pages are never written — except an exact
        full-prompt hit, where the mandatory last-token re-run (the
        sample needs its logits) lands inside the deepest shared page.
        That page is copied into a fresh page before scheduling."""
        if self._prefix is None:
            slot = self._alloc_slot_pages(req)
            return None if slot is None else (slot, 0)
        page = self.config.page_size
        hit_pages = self._prefix.acquire(req.prompt)
        d = len(hit_pages)
        start = hit = d * page
        cow = d > 0 and hit >= len(req.prompt)
        if cow:
            start = len(req.prompt) - 1
        slot = self._alloc_slot_pages(
            req, need=self._pages_needed(req) - d + (1 if cow else 0))
        if slot is None:
            self._prefix.release(hit_pages)
            self._update_page_gauges()
            return None
        fresh = self._slot_pages[slot]
        if cow:
            src, dst = hit_pages[-1], fresh[0]
            self._cache = self.adapter.copy_page(self._cache, src, dst)
            self._prefix.release([src])
            borrowed = hit_pages[:-1]
            pages = borrowed + [dst] + fresh[1:]
        else:
            borrowed = hit_pages
            pages = borrowed + fresh
        self._slot_pages[slot] = pages
        self._slot_borrowed[slot] = borrowed
        row = np.full((self._maxp,), self._num_pages, np.int32)
        row[: len(pages)] = pages
        self._bt[slot] = row
        req.prefix_hit = start
        self._prefix_hit_tokens += start
        self._prefix_prompt_tokens += len(req.prompt)
        self._tm["prefix_requests"].inc(
            tags={"outcome": "hit" if start else "miss"})
        self._tm["prefix_hit_depth"].observe(start)
        if self._prefix_prompt_tokens:
            self._tm["prefix_hit_ratio"].set(
                self._prefix_hit_tokens / self._prefix_prompt_tokens)
        self._update_page_gauges()
        return slot, start

    def _update_page_gauges(self) -> None:
        if not self._paged:
            return
        self._tm["kv_pages_free"].set(len(self._free_pages))
        cached = self._prefix.cached_pages if self._prefix else 0
        self._tm["kv_pages_cached"].set(cached)
        if self._prefix is not None:
            self._tm["prefix_cached_pages"].set(cached)

    def _admit_paged(self) -> None:
        """A request needs pages for max(prefill bucket, prompt+max_new)
        tokens; when the pool can't cover it, it waits in the backlog.
        Requests of one bucket prefill together, padded to a power of
        two rows with copies of the last row.  With chunked prefill,
        prompts longer than a chunk join the incremental track instead
        of a one-shot bucket."""
        page = self.config.page_size
        pc = self.config.prefill_chunk
        while self._chunked and self._free_slots:
            # Peek for a long prompt; admit it incrementally.
            if self._backlog and len(self._backlog[0].prompt) > pc:
                req = self._backlog.pop(0)
            elif not self._backlog:
                try:
                    req = self._waiting.get_nowait()
                except queue.Empty:
                    break
                if len(req.prompt) <= pc:
                    # Short prompt: the batched admission below.
                    self._backlog.insert(0, req)
                    break
            else:
                break
            slot = self._alloc_slot_pages(req)
            if slot is None:
                self._backlog.insert(0, req)
                break
            req.admitted_at = time.monotonic()
            self._ring.record(req.request_id, _reqev.PREFILLING, slot=slot,
                              num_pages=len(self._slot_pages[slot]))
            self._prefilling.append({"req": req, "slot": slot, "pos": 0})
        while self._free_slots:
            batch: List[Tuple[Request, int]] = []
            group_bucket = None
            while self._free_slots and len(batch) < 8:
                if self._backlog:
                    req = self._backlog.pop(0)
                else:
                    try:
                        req = self._waiting.get_nowait()
                    except queue.Empty:
                        break
                bucket = self._paged_bucket_for(len(req.prompt))
                if group_bucket is None:
                    group_bucket = bucket
                elif bucket != group_bucket:
                    # One bucket per prefill group; mismatches lead the
                    # next group.
                    self._backlog.append(req)
                    break
                slot = self._alloc_slot_pages(req)
                if slot is None:
                    self._backlog.append(req)  # wait for page frees
                    break
                batch.append((req, slot))
            if not batch:
                return
            bucket = group_bucket
            k = 1
            while k < len(batch):
                k *= 2
            tokens = np.zeros((k, bucket), np.int32)
            true_lens = np.zeros((k,), np.int32)
            pages_rows = np.zeros((k, bucket // page), np.int32)
            temps = np.zeros((k,), np.float32)
            slot_ids = np.zeros((k,), np.int32)
            for i in range(k):
                req, slot = batch[min(i, len(batch) - 1)]  # pad = copy
                tokens[i, : len(req.prompt)] = req.prompt
                true_lens[i] = len(req.prompt)
                pages_rows[i] = self._bt[slot][: bucket // page]
                temps[i] = req.temperature
                slot_ids[i] = slot
            for req, slot in batch:
                self._lens[slot] = len(req.prompt)
            self._admitting = [req for req, _slot in batch]
            # Padding rows keep an OOB scatter id: their sample (which
            # differs at temperature > 0) must never land in cur.
            scatter_ids = slot_ids.copy()
            scatter_ids[len(batch):] = self.config.max_slots
            toks_dev = self._run_prefill(tokens, true_lens, pages_rows,
                                         temps, scatter_ids)
            self._finish_admit(batch, toks_dev)

    def _admit_dense(self) -> None:
        """Dense admission, the JAX engine's: up to 8 waiting requests,
        one free slot each, prefill in one dispatch padded to a power of
        two rows (copies of the last row, whose samples scatter out of
        bounds) and to the largest prompt bucket of the group."""
        while self._free_slots:
            batch: List[Tuple[Request, int]] = []
            while self._free_slots and len(batch) < 8:
                try:
                    req = self._waiting.get_nowait()
                except queue.Empty:
                    break
                batch.append((req, self._free_slots.pop()))
            if not batch:
                return
            bucket = max(self._bucket_for(len(r.prompt)) for r, _ in batch)
            k = 1
            while k < len(batch):
                k *= 2
            tokens = np.zeros((k, bucket), np.int32)
            true_lens = np.zeros((k,), np.int32)
            slot_ids = np.zeros((k,), np.int32)
            temps = np.zeros((k,), np.float32)
            for i in range(k):
                req, slot = batch[min(i, len(batch) - 1)]  # pad = copy
                tokens[i, : len(req.prompt)] = req.prompt
                true_lens[i] = len(req.prompt)
                slot_ids[i] = slot
                temps[i] = req.temperature
            for req, slot in batch:
                self._lens[slot] = len(req.prompt)
            self._admitting = [req for req, _slot in batch]
            scatter_ids = slot_ids.copy()
            scatter_ids[len(batch):] = self.config.max_slots
            toks_dev = self._run_prefill(tokens, true_lens, slot_ids, temps,
                                         scatter_ids)
            self._finish_admit(batch, toks_dev)

    def _admit_ragged(self) -> None:
        """Ragged admission: EVERY request claims its slot and pages up
        front and joins the incremental track; the unified step packs
        its prompt in budget-sized chunks beside live decode rows, so no
        separate prefill program can block them.  A request with an
        adapter borrows its pages first: pool pressure (every resident
        adapter borrowed) sends it back to the backlog like page
        pressure, and a loader error fails that request only."""
        from ray_tpu_torch.serve.adapter_pool import AdapterPoolPressure

        while self._free_slots:
            if self._backlog:
                req = self._backlog.pop(0)
            else:
                try:
                    req = self._waiting.get_nowait()
                except queue.Empty:
                    return
            if req.adapter_id:
                try:
                    self._adapters.acquire(req.adapter_id)
                except AdapterPoolPressure:
                    self._backlog.insert(0, req)
                    return
                except Exception as e:  # the loader's failure is the
                    # request's, never the engine's
                    log.warning("adapter %r load failed", req.adapter_id,
                                exc_info=True)
                    req.finished_at = time.monotonic()
                    self._observe_request(
                        req, state=_reqev.FAILED,
                        cause=f"adapter load failed: {e!r}")
                    req.stream.put(RuntimeError(
                        f"adapter {req.adapter_id!r} load failed: {e!r}"))
                    continue
            got = self._admit_slot_for(req)
            if got is None:
                if req.adapter_id:
                    self._adapters.release(req.adapter_id)
                self._backlog.insert(0, req)
                return
            slot, start = got
            if req.adapter_id:
                self._slot_adapter[slot] = req.adapter_id
            req.admitted_at = time.monotonic()
            self._ring.record(req.request_id, _reqev.PREFILLING, slot=slot,
                              num_pages=len(self._slot_pages[slot]),
                              prefix_hit=req.prefix_hit)
            self._prefilling.append({"req": req, "slot": slot,
                                     "pos": start})
            self._state_dirty = True  # bt rows changed

    def _run_prefill(self, tokens, true_lens, slot_or_pages, temps,
                     scatter_ids) -> torch.Tensor:
        """One batched prefill (``slot_or_pages``: each row's pages, or
        its slot on a dense adapter); the sampled first tokens scatter
        into the device cur (OOB scatter ids dropped).  A dense adapter
        without prefill_batch prefills the rows one prefill_slot call at
        a time, as the JAX engine's loop of rows does."""
        # Padding rows are device work too: they count as prefill tokens.
        self._count_step_tokens("prefill", int(np.sum(true_lens)))
        t0 = self._first_dispatch("serve.prefill")
        toks_d, lens_d = self._h2d(tokens), self._h2d(true_lens)
        rows_d = self._h2d(slot_or_pages)
        if self.adapter.prefill_batch is not None:
            logits, self._cache = self.adapter.prefill_batch(
                self._params, toks_d, lens_d, rows_d, self._cache)
        else:
            rows = []
            for i in range(tokens.shape[0]):
                row, self._cache = self.adapter.prefill_slot(
                    self._params, toks_d[i], lens_d[i], rows_d[i],
                    self._cache)
                rows.append(row)
            logits = torch.stack(rows)
        if t0 is not None:
            self._register_program(
                "serve.prefill", t0, span_name="llm.prefill",
                rows=[(0, int(n)) for n in true_lens],
                logit_rows=len(true_lens),
                cost_steps=float(np.sum(true_lens)))
        toks = _sample(logits, self._h2d(temps),
                       self._gen if (temps > 0).any() else None)
        keep = np.nonzero(scatter_ids < self.config.max_slots)[0]
        self._cur_dev[self._h2d(scatter_ids[keep].astype(np.int64))] = \
            toks[self._h2d(keep.astype(np.int64))]
        return toks

    def _finish_admit(self, batch, toks_dev) -> None:
        """Register the slots now (decode chunks dispatch behind the
        prefill without waiting); the first tokens ride the fetch
        pipeline."""
        now = time.monotonic()
        for req, slot in batch:
            self._slot_req[slot] = req
            self._temps[slot] = req.temperature
            if req.admitted_at is None:
                req.admitted_at = now
            self._ring.record(
                req.request_id, _reqev.PREFILLING, slot=slot,
                num_pages=(len(self._slot_pages.get(slot, []))
                           if self._paged else None))
            # The pending first token counts against the budget until
            # the prefill entry is processed.
            self._inflight_tokens[slot] = \
                self._inflight_tokens.get(slot, 0) + 1
        self._admitting = []
        self._state_dirty = True
        self._enqueue_fetch("prefill", toks_dev, 0, list(batch))

    # -- decode ------------------------------------------------------------

    def _refresh_state_args(self) -> None:
        if not self._state_dirty:
            return
        active = np.zeros((self.config.max_slots,), bool)
        for slot in self._slot_req:
            active[slot] = True
        self._active_dev = self._h2d(active)
        self._temps_dev = self._h2d(self._temps)
        self._any_sampled = bool((self._temps[active] > 0).any())
        if self._paged:
            # The dense cache keeps its lengths on the device itself.
            self._bt_dev = self._h2d(self._bt)
            self._lens_dev = self._h2d(self._lens)
        self._state_dirty = False

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A host array as a new device tensor.  On the card the copy is
        non-blocking from pinned memory: a blocking copy would wait for
        every decode chunk already queued."""
        t = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _chunk_size(self) -> int:
        """Largest chunk of the ladder that no active request can
        out-finish given tokens already in flight (so only EOS ends a
        request mid-chunk); 0 = every budget is covered by in-flight
        work.  Sized by the LONGEST-remaining request: shorter ones
        finish mid-chunk and their overshoot writes land in their own
        spare pages or the scratch page."""
        remaining = max(
            min(req.max_new_tokens - len(req.tokens),
                self.config.max_seq_len - len(req.prompt) - len(req.tokens))
            - self._inflight_tokens.get(slot, 0)
            for slot, req in self._slot_req.items())
        for k in self._chunk_ladder:
            if k <= remaining:
                return k
        return self._chunk_ladder[-1] if remaining > 0 else 0

    def _dispatch_decode(self, chunk: int) -> None:
        """Enqueue one decode chunk without a host sync: cur and lens
        stay on the device from the previous chunk."""
        self._refresh_state_args()
        gen = self._gen if self._any_sampled else None
        cur, lens = self._cur_dev, self._lens_dev
        t0 = self._first_dispatch("serve.decode")
        steps = []
        for _ in range(chunk):
            if self._paged:
                logits, self._cache, lens = self.adapter.decode_slots(
                    self._params, cur, self._active_dev, self._bt_dev, lens,
                    self._cache)
            else:
                logits, self._cache = self.adapter.decode_slots(
                    self._params, cur, self._active_dev, self._cache)
            toks = _sample(logits, self._temps_dev, gen)
            cur = torch.where(self._active_dev, toks, cur)
            steps.append(cur)
        if t0 is not None:
            # One decode step's cost (the weights read once), over the
            # active slots' lengths; the chunk is its cost_steps, as in
            # the JAX engine.
            self._register_program(
                "serve.decode", t0, span_name="llm.decode",
                rows=[(int(self._lens[slot]), 1) for slot in self._slot_req],
                logit_rows=len(self._slot_req), steps_attr="tokens",
                cost_steps=float(chunk))
        self._cur_dev, self._lens_dev = cur, lens
        # Host mirror advances for slots active in THIS dispatch.
        for slot in self._slot_req:
            self._lens[slot] += chunk
        self._steps += chunk
        self._count_step_tokens("decode", chunk * len(self._slot_req))
        self._tm["batch_size"].observe(len(self._slot_req))
        self._observe_queue()
        participants = list(self._slot_req.items())
        for slot, _req in participants:
            self._inflight_tokens[slot] = \
                self._inflight_tokens.get(slot, 0) + chunk
        self._enqueue_fetch("decode", torch.stack(steps), chunk,
                            participants)

    def _dispatch_prefill_chunk(self) -> None:
        """Advance the oldest incremental prefill by one chunk (between
        decode chunks, so a long prompt never blocks running streams for
        its whole prefill).  A mid-prompt chunk enters the fetch pipe as
        a marker, so chunk dispatch is pipeline-gated like decode; the
        last chunk's sample is the request's first token."""
        st = self._prefilling[0]
        req, slot, pos = st["req"], st["slot"], st["pos"]
        C = self.config.prefill_chunk
        chunk = req.prompt[pos:pos + C]
        tokens = np.zeros((1, C), np.int32)
        tokens[0, :len(chunk)] = chunk
        is_last = pos + len(chunk) >= len(req.prompt)
        # Attend only over pages covering the prompt so far (rounded up
        # to a power of two): a chunk must not pay max_seq_len-wide
        # attention.
        covered = -(-(pos + len(chunk)) // self.config.page_size)
        nb = 1
        while nb < covered:
            nb *= 2
        nb = min(nb, self._maxp)
        logits, self._cache = self.adapter.prefill_chunk(
            self._params, self._h2d(tokens),
            self._h2d(np.asarray([pos], np.int32)),
            self._h2d(np.asarray([len(chunk)], np.int32)),
            self._h2d(self._bt[slot][None, :nb]), self._cache)
        toks = _sample(logits,
                       self._h2d(np.asarray([req.temperature], np.float32)),
                       self._gen if req.temperature > 0 else None)
        st["pos"] = pos + len(chunk)
        self._count_step_tokens("prefill", len(chunk))
        if is_last:
            self._prefilling.pop(0)
            self._cur_dev[slot] = toks[0]
            self._lens[slot] = len(req.prompt)
            self._finish_admit([(req, slot)], toks)
        else:
            self._enqueue_fetch("pfchunk", toks, 0, [])

    # -- speculative decoding: the draft round -----------------------------

    def _draft_alloc(self, req: Request, slot: int) -> bool:
        """Claim draft-pool pages for a slot's first speculative round,
        sized like its target allocation.  False = the draft pool is
        exhausted; the slot decodes plainly until pages free."""
        if slot in self._draft_slot_pages:
            return True
        need = self._pages_needed(req)
        if len(self._draft_free) < need:
            return False
        pages = [self._draft_free.pop() for _ in range(need)]
        self._draft_slot_pages[slot] = pages
        row = np.full((self._maxp,), self._draft_pages, np.int32)
        row[: len(pages)] = pages
        self._draft_bt[slot] = row
        self._draft_fed[slot] = 0
        return True

    def _run_draft(self, toks, tok_pos, row_slot, row_start, row_len,
                   row_off) -> torch.Tensor:
        """One draft-model ragged step over ``toks`` (host int32 tokens or
        a device tensor); returns the device [R] per-row argmax (a row
        fed through its sequence end gives that slot's next draft)."""
        R = self.config.max_slots
        on_host = isinstance(toks, np.ndarray)
        segs = [tok_pos, row_slot, row_start, row_len, row_off,
                self._draft_bt.reshape(-1)]
        dev = self._upload(segs + [toks] if on_host else segs)
        t_pos, r_slot, r_start, r_len, r_off, bt = dev[:6]
        if on_host:
            toks = dev[6]
        self._spec_draft_steps += 1
        # The round's first step (host tokens) feeds each candidate's
        # backlog; later ones chain one-token drafts.
        name = "serve.spec_draft" if on_host else "serve.spec_chain"
        t0 = self._first_dispatch(name)
        logits, self._draft_cache = self._draft_adapter.ragged_step(
            self._draft_params, toks, t_pos, r_slot, r_start, r_len, r_off,
            bt.view(R, self._maxp), self._draft_cache)
        out = logits.argmax(dim=-1).to(torch.int32)
        if t0 is not None:
            live = [(int(a), int(n)) for a, n in zip(row_start, row_len) if n]
            self._register_program(
                name, t0, span_name="llm.spec_draft", rows=live,
                logit_rows=len(live), costs=self._draft_costs)
        return out

    def _spec_rem(self, req: Request) -> int:
        """Tokens the request may still emit (no in-flight charge:
        speculation only plans on fully idle slots)."""
        return min(req.max_new_tokens - len(req.tokens),
                   self.config.max_seq_len - len(req.prompt)
                   - len(req.tokens))

    def _spec_draft_round(self) -> Dict[int, List[int]]:
        """Plan and run ONE draft round: pick this dispatch's candidates
        (greedy, base-model, fully idle slots that have their first
        token), catch the draft KV up to each candidate's sequence (one
        ragged feed whose row argmaxes are the first drafts; catch-up
        rows of slots that do not fit pack after the candidates), chain
        up to spec_k - 1 one-token draft steps, and return {slot: draft
        tokens}.  The stacked drafts reach the host in ONE device→host
        copy, the round's one sync; the verify step stays pipelined."""
        R, Td = self.config.max_slots, self._token_budget
        k_cfg = self.config.spec_k
        active = sorted(self._slot_req)
        # Every active slot takes at least one token of the verify
        # dispatch's budget; a candidate spends k_eff on top of it.
        budget_left = Td - len(active)
        feed_left = Td
        plan: List[Tuple[int, Request, int, int]] = []  # candidate i = row i
        feed_rows: List[Dict[str, Any]] = []
        catchup_rows: List[Dict[str, Any]] = []
        for slot in active:
            req = self._slot_req[slot]
            if (slot in self._spec_inflight
                    or self._inflight_tokens.get(slot, 0)
                    or req.temperature != 0.0 or req.adapter_id
                    or req.first_token_at is None):
                continue
            k_eff = min(k_cfg, self._spec_rem(req) - 1, budget_left)
            if k_eff < 1 or not self._draft_alloc(req, slot):
                continue
            seq = req.prompt + req.tokens
            fed = self._draft_fed.get(slot, 0)
            backlog = seq[fed:]
            if (len(backlog) > feed_left
                    or len(feed_rows) + len(catchup_rows) >= R):
                # Cannot catch up this round: feed what fits (the draft
                # KV persists across rounds) and decode plainly meanwhile.
                if feed_left > 0 and len(feed_rows) + len(catchup_rows) < R:
                    part = backlog[:feed_left]
                    catchup_rows.append({"slot": slot, "start": fed,
                                         "tokens": [int(t) for t in part]})
                    self._draft_fed[slot] = fed + len(part)
                    feed_left = 0
                continue
            feed_rows.append({"slot": slot, "start": fed,
                              "tokens": [int(t) for t in backlog]})
            feed_left -= len(backlog)
            self._draft_fed[slot] = len(seq)
            plan.append((slot, req, k_eff, len(seq)))
            budget_left -= k_eff
        feed_rows += catchup_rows
        if not feed_rows:
            return {}
        packed = pack_ragged_batch(feed_rows, Td, R)
        nxt = self._run_draft(packed[0], *packed[3:])
        self._count_step_tokens(
            "spec_draft", sum(len(r["tokens"]) for r in feed_rows))
        if not plan:
            return {}
        max_k = max(k for _s, _r, k, _n in plan)
        outs = [nxt]
        row_off = np.arange(R, dtype=np.int32)
        for m in range(2, max_k + 1):
            row_slot = np.zeros((R,), np.int32)
            row_start = np.zeros((R,), np.int32)
            row_len = np.zeros((R,), np.int32)
            tok_pos = np.zeros((Td,), np.int32)
            for i, (slot, _req, k_eff, seq_len) in enumerate(plan):
                if k_eff < m:
                    continue  # shorter chains idle as length-0 rows
                row_slot[i] = slot
                row_start[i] = tok_pos[i] = seq_len + m - 2
                row_len[i] = 1
            # One-token rows at row_off = arange(R): the previous step's
            # [R] argmax IS the head of the flat token buffer.
            toks = torch.zeros((Td,), dtype=torch.int32, device=self.device)
            toks[:R] = outs[-1]
            outs.append(self._run_draft(toks, tok_pos, row_slot, row_start,
                                        row_len, row_off))
            self._count_step_tokens("spec_draft", int(row_len.sum()))
        stacked = torch.stack(outs).cpu().numpy()
        return {slot: [int(stacked[m, i]) for m in range(k_eff)]
                for i, (slot, _req, k_eff, _n) in enumerate(plan)}

    # -- ragged unified step -----------------------------------------------

    def _dispatch_ragged_step(self) -> bool:
        """Pack and dispatch ONE unified ragged step: first a decode row
        (one token) or a verify row (the slot's true last token and its
        k drafts) for every running slot with budget left, then prompt
        chunks from the incremental track until token_budget is full.
        Decode rows are never displaced by prompt tokens: that priority
        is the no-stall guarantee; and drafting never runs while prompt
        chunks wait for the budget.  Returns False when nothing fit
        (every slot budget-capped by in-flight tokens, no prompt
        pending)."""
        T, R = self._token_budget, self.config.max_slots
        budget = T
        rows: List[Dict[str, Any]] = []
        parts: List[Tuple[str, Request, int, Any]] = []
        scatter = np.full((R,), R, np.int32)  # R = sample dropped
        temps = np.zeros((R,), np.float32)
        n_decode = n_prefill = n_spec = 0
        # Draft only on uncontended dispatches: pending prompt chunks
        # always win the budget over draft tokens, and a cold acceptance
        # EMA pauses drafting for a while.
        drafts: Dict[int, List[int]] = {}
        spec_round = (self._spec_on and bool(self._slot_req)
                      and not self._prefilling)
        if spec_round and self._spec_cooldown > 0:
            self._spec_cooldown -= 1
            spec_round = False
        if spec_round:
            drafts = self._spec_draft_round()
        # The step's adapter gather set: distinct adapter ids -> index
        # 1..K-1 (0 is the null adapter).  A row whose adapter would
        # overflow the set waits for the next step.
        step_adapters: Dict[str, int] = {}

        def adapter_idx(req: Request) -> Optional[int]:
            if not req.adapter_id:
                return 0
            idx = step_adapters.get(req.adapter_id)
            if idx is None:
                if len(step_adapters) >= self.config.max_batch_adapters - 1:
                    return None
                idx = len(step_adapters) + 1
                step_adapters[req.adapter_id] = idx
            return idx

        for slot in sorted(self._slot_req):
            if budget <= 0 or len(rows) >= R:
                break
            if self._spec_on and slot in self._spec_inflight:
                continue  # verify round in flight: the slot is idle
            req = self._slot_req[slot]
            rem = min(req.max_new_tokens - len(req.tokens),
                      self.config.max_seq_len - len(req.prompt)
                      - len(req.tokens)) \
                - self._inflight_tokens.get(slot, 0)
            if rem <= 0:
                continue  # its budget is covered by in-flight steps
            ai = adapter_idx(req)
            if ai is None:
                continue
            seq_last = int(req.tokens[-1] if req.tokens else req.prompt[-1])
            dr = drafts.get(slot)
            if dr and budget >= len(dr) + 1 and rem > len(dr):
                # Verify row: the true last token and the k drafts as ONE
                # k+1-token row at the current length.  The target's
                # logits at every position come back with the step; the
                # row's own sample is dropped (the accept boundary is
                # resolved on the host at fetch).
                i = len(rows)
                rows.append({"slot": slot, "start": int(self._lens[slot]),
                             "tokens": [seq_last] + dr, "adapter": ai})
                parts.append(("verify", req, slot,
                              {"drafts": dr, "row": i,
                               "base_len": int(self._lens[slot])}))
                budget -= len(dr) + 1
                n_spec += len(dr) + 1
                continue
            if (spec_round and dr is None
                    and self._inflight_tokens.get(slot, 0) > 0
                    and req.temperature == 0.0 and not req.adapter_id
                    and req.first_token_at is not None
                    and self._spec_rem(req) >= 2
                    and (slot in self._draft_slot_pages
                         or len(self._draft_free)
                         >= self._pages_needed(req))):
                # A slot that could speculate but has steps in flight:
                # hold further decode rows so its pipeline drains and the
                # NEXT round can draft for it (k accepted tokens per
                # verify step beat depth-k pipelining of one-token
                # steps).  Cooldown and prompt contention clear
                # spec_round and restore plain pipelining.
                continue
            i = len(rows)
            if self._spec_on and slot in self._spec_stale_cur:
                # The device cur went stale at the slot's last verify
                # round: a host-token row computes the same decode step
                # and its scatter re-seeds cur.
                rows.append({"slot": slot, "start": int(self._lens[slot]),
                             "tokens": [seq_last], "adapter": ai})
            else:
                # The token lives on the device (cur): no host round trip.
                rows.append({"slot": slot, "start": int(self._lens[slot]),
                             "tokens": None, "adapter": ai})
            parts.append(("decode", req, slot, i))
            scatter[i] = slot
            temps[i] = req.temperature
            budget -= 1
            n_decode += 1
        finishing = []
        for st in self._prefilling:
            if budget <= 0 or len(rows) >= R:
                break
            req, slot, pos = st["req"], st["slot"], st["pos"]
            chunk = req.prompt[pos:pos + budget]
            if not chunk:
                continue
            ai = adapter_idx(req)
            if ai is None:
                continue
            i = len(rows)
            rows.append({"slot": slot, "start": pos,
                         "tokens": [int(t) for t in chunk], "adapter": ai})
            temps[i] = req.temperature
            if pos + len(chunk) >= len(req.prompt):
                # The last chunk's sample is the first token; mid-prompt
                # rows keep the dropped scatter id.
                parts.append(("first", req, slot, i))
                scatter[i] = slot
                finishing.append(st)
            st["pos"] = pos + len(chunk)
            budget -= len(chunk)
            n_prefill += len(chunk)
        if not rows:
            return False
        self._refresh_state_args()
        packed = pack_ragged_batch(rows, T, R,
                                   with_adapters=bool(step_adapters))
        logit_idx = None
        if n_spec:
            # Flat-buffer positions of every verify row's k+1 tokens
            # (static width, padded with 0), and each part's offset into
            # the returned verify vector.
            logit_idx = np.zeros((self._spec_tv,), np.int32)
            voff = 0
            for kind, _req, _slot, info in parts:
                if kind != "verify":
                    continue
                n = len(info["drafts"]) + 1
                off = int(packed[7][info["row"]])
                logit_idx[voff:voff + n] = np.arange(off, off + n)
                info["voff"] = voff
                voff += n
        page_table = (self._adapters.page_table(list(step_adapters))
                      if step_adapters else None)
        t_start = time.monotonic()
        toks_dev = self._run_ragged(packed, scatter, temps, logit_idx,
                                    page_table)
        for kind, req, slot, info in parts:
            if kind == "verify":
                # The slot idles until its accept boundary returns: its
                # length moves only at fetch, which is the rollback point.
                self._inflight_tokens[slot] = len(info["drafts"]) + 1
                self._spec_inflight.add(slot)
                continue
            if kind == "decode":
                self._lens[slot] += 1  # the mirror advances at dispatch
                if self._spec_on:
                    self._spec_stale_cur.discard(slot)
            self._inflight_tokens[slot] = \
                self._inflight_tokens.get(slot, 0) + 1
        now = time.monotonic()
        for st in finishing:
            self._prefilling.remove(st)
            req, slot = st["req"], st["slot"]
            self._lens[slot] = len(req.prompt)
            self._slot_req[slot] = req
            self._temps[slot] = req.temperature
            if req.admitted_at is None:
                req.admitted_at = now
        self._steps += 1
        self._count_step_tokens("decode", n_decode)
        self._count_step_tokens("prefill", n_prefill)
        if n_spec:
            self._count_step_tokens("spec_verify", n_spec)
        if n_decode and n_prefill:
            self._mixed_steps += 1
        if n_decode:
            self._tm["batch_size"].observe(n_decode)
        self._observe_queue()
        self._enqueue_fetch("ragged", toks_dev, 1, parts, t_start=t_start)
        return True

    def _count_step_tokens(self, phase: str, n: int) -> None:
        """Tokens dispatched to the device in one phase: the stats mirror
        and raytpu_serve_step_tokens_total{phase}."""
        self._step_tokens[phase] = self._step_tokens.get(phase, 0) + n
        self._tm["step_tokens"].inc(n, tags={"phase": phase})

    def _observe_queue(self) -> None:
        """The admission queue's depth and age gauges, sampled at
        dispatch."""
        self._tm["queue_depth"].set(self._waiting.qsize()
                                    + len(self._backlog))
        self._tm["queue_age"].set(self._admission_queue_age())

    def _upload(self, segs: List[np.ndarray]) -> List[torch.Tensor]:
        """Host int32 arrays as device tensors through ONE buffer
        (pinned, non-blocking on the card), sliced on the device; each
        slice starts on a 16-byte boundary (the kernel wrappers reject
        unaligned pointers)."""
        widths = [-(-len(a) // 4) * 4 for a in segs]
        buf = np.zeros((sum(widths),), np.int32)
        cuts, at = [], 0
        for a, w in zip(segs, widths):
            buf[at:at + len(a)] = a
            cuts.append((at, at + len(a)))
            at += w
        dev = self._h2d(buf)
        return [dev[a:b] for a, b in cuts]

    def _run_ragged(self, packed, scatter: np.ndarray, temps: np.ndarray,
                    logit_idx: Optional[np.ndarray] = None,
                    page_table: Optional[np.ndarray] = None
                    ) -> torch.Tensor:
        """One ragged step on the device: the base step, or its LoRA
        (``page_table`` given), verify (``logit_idx`` given) or LoRA
        verify variant.  The step's host arrays travel as ONE upload.
        Decode rows read their token from the device cur; the row
        samples scatter into cur, dropping scatter id R (mid-prompt,
        verify and padding rows).  Returns the [R] row samples, followed
        on a verify step by the target argmax at each logit_idx
        position."""
        R = self.config.max_slots
        (host_toks, decode_mask, tok_slot, tok_pos, row_slot, row_start,
         row_len, row_off) = packed[:8]
        segs = [host_toks, decode_mask.astype(np.int32), tok_slot, tok_pos,
                row_slot, row_start, row_len, row_off, scatter,
                temps.view(np.int32)]
        if page_table is not None:
            segs += [packed[8], page_table.reshape(-1)]
        if logit_idx is not None:
            segs.append(logit_idx)
        name = "serve.ragged" if logit_idx is None else "serve.ragged_spec"
        t0 = self._first_dispatch(name)
        dev = self._upload(segs)
        (h_toks, d_mask, t_slot, t_pos, r_slot, r_start, r_len, r_off,
         scatter_d, temps_d) = dev[:10]
        toks = torch.where(d_mask != 0, self._cur_dev[t_slot.long()], h_toks)
        args = (self._params, toks, t_pos, r_slot, r_start, r_len, r_off,
                self._bt_dev, self._cache)
        if page_table is not None:
            args += (self._adapters.device_pool,
                     dev[11].view(page_table.shape), dev[10])
        if logit_idx is None:
            step = (self.adapter.ragged_step if page_table is None
                    else self.adapter.ragged_step_lora)
            logits, self._cache = step(*args)
        else:
            step = (self.adapter.ragged_step_verify if page_table is None
                    else self.adapter.ragged_step_lora_verify)
            logits, vlogits, self._cache = step(*args, dev[-1])
        sampled = _sample(logits, temps_d.view(torch.float32),
                          self._gen if (temps > 0).any() else None)
        if t0 is not None:
            live = [(int(a), int(n)) for a, n in zip(row_start, row_len) if n]
            self._register_program(
                name, t0, span_name="llm.ragged", rows=live,
                logit_rows=len(live), steps_attr="tokens",
                cost_steps=float(self._token_budget))
        cur = torch.empty((R + 1,), dtype=torch.int32, device=self.device)
        cur[:R] = self._cur_dev
        cur[scatter_d.long()] = sampled
        self._cur_dev = cur[:R]
        if logit_idx is None:
            return sampled
        # The target's argmax at every verify position, on the device:
        # the fetch carries k+1 ints per verify row, not k+1 logit rows.
        return torch.cat([sampled, vlogits.argmax(dim=-1).to(torch.int32)])

    # -- token delivery ----------------------------------------------------

    def _enqueue_fetch(self, kind: str, toks: torch.Tensor, chunk: int,
                       participants, t_start: Optional[float] = None
                       ) -> None:
        """Start the one device→host copy of a dispatch's tokens
        (``t_start``: where the dispatch's host enqueue began)."""
        event = None
        if toks.is_cuda:
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = toks
        now = time.monotonic()
        self._pending.append(_InFlight(
            kind, host, event, chunk, participants, now,
            now if t_start is None else t_start))

    def _process_fetched(self, block: bool) -> bool:
        """Emit every dispatch whose tokens have reached the host, in
        dispatch order; ``block`` waits for the oldest one."""
        processed = False
        while self._pending:
            entry = self._pending[0]
            if entry.event is not None and not entry.event.query():
                if not block or processed:
                    return processed
                entry.event.synchronize()
            self._pending.popleft()
            processed = True
            toks = entry.host.numpy()
            now = time.monotonic()
            if entry.kind == "decode":
                self._note_step_time(now - entry.t_disp, entry.chunk)
            if entry.kind == "pfchunk":
                continue  # a marker: it only gated the pipeline depth
            if entry.kind == "ragged":
                # One unified step: toks is the [R] row-sample vector
                # (then, on a verify step, the target argmax at each
                # verify position); the parts are decode rows, verify
                # rows and last prompt chunks (mid-prompt rows have
                # nothing to emit).  Its wall feeds the stall watermark:
                # a ragged step is a decode step for every stream in it.
                self._note_step_time(now - entry.t_disp, 1)
                if tracing.is_enabled():
                    # From the start of the step's host enqueue to its
                    # fetch: an upper bound on its device time, the
                    # roofline's serve.ragged wall (tokens = the device
                    # steps the span covers).
                    off = time.time() - now
                    tracing.record_span("llm.ragged", entry.t_start + off,
                                        now + off, attributes={"tokens": 1})
                R = self.config.max_slots
                for rkind, req, slot, i in entry.participants:
                    if rkind == "verify":
                        self._finish_verify(req, slot, i, toks[R:])
                        continue
                    self._drop_inflight(slot, 1)
                    if req.finished_at is not None:
                        continue  # cancelled or preempted while in flight
                    if rkind == "first":
                        req.first_token_at = now
                        self._ring.record(req.request_id, _reqev.DECODING)
                        self._emit(req, slot, int(toks[i]))
                    elif self._slot_req.get(slot) is req:
                        self._emit(req, slot, int(toks[i]))
                continue
            if entry.kind == "prefill":
                for i, (req, slot) in enumerate(entry.participants):
                    self._drop_inflight(slot, 1)
                    if req.finished_at is not None:
                        continue  # cancelled or preempted in its prefill
                    req.first_token_at = now
                    self._ring.record(req.request_id, _reqev.DECODING)
                    self._emit(req, slot, int(toks[i]))
                continue
            for slot, req in entry.participants:
                self._drop_inflight(slot, entry.chunk)
                if self._slot_req.get(slot) is not req:
                    continue  # finished in an earlier chunk: overshoot
                for k in range(entry.chunk):
                    self._emit(req, slot, int(toks[k, slot]))
                    if self._slot_req.get(slot) is not req:
                        break  # finished mid-chunk
        return processed

    def _finish_verify(self, req: Request, slot: int, info: Dict[str, Any],
                       ver: np.ndarray) -> None:
        """Resolve one fetched verify round: accept the longest draft
        prefix that matches the target's argmaxes plus the bonus token
        the target computed past it, rewind the slot's length to the
        accept boundary, and emit the burst.

        Rollback safety: the target wrote KV for all k+1 positions, but
        ``_lens[slot]`` only moves to ``base_len + 1 + j``; every later
        step (and draft feed) writes from there, so rejected positions
        are overwritten before anything attends to them, int8 page
        scales (grow-only) merely stay larger than the accepted rows
        need, and the finish path donates only ``seq[:-1]``, inside the
        accepted prefix, to the prefix cache."""
        drafts, base_len = info["drafts"], info["base_len"]
        k = len(drafts)
        self._spec_inflight.discard(slot)
        # The round's whole k+1 charge drops at once (speculation only
        # starts on slots with nothing in flight).
        self._drop_inflight(slot, k + 1)
        voff = info["voff"]
        row_ver = [int(t) for t in ver[voff:voff + k + 1]]
        j = 0
        while j < k and drafts[j] == row_ver[j]:
            j += 1
        self._spec_rounds += 1
        self._spec_drafted_total += k
        self._spec_accepted_total += j
        self._tm["spec_rounds"].inc()
        self._tm["spec_drafted"].inc(k)
        if j:
            self._tm["spec_accepted"].inc(j)
        self._tm["spec_accept_ratio"].set(
            self._spec_accepted_total / self._spec_drafted_total)
        self._spec_ema = 0.8 * self._spec_ema + 0.2 * (j / k)
        if (self._spec_cooldown == 0
                and self._spec_ema < self.config.spec_cold_accept):
            # Acceptance ran cold: decode plainly for a while, then probe
            # again with a reset EMA.
            self._spec_cooldown = self.config.spec_cooldown_rounds
            self._spec_cooldowns += 1
            self._spec_ema = 1.0
        if req.finished_at is not None or self._slot_req.get(slot) is not req:
            return  # cancelled while the verify was in flight
        # Draft rollback: the draft fed seq[-1], d1 .. d(k-1) at
        # base_len .. base_len + k - 1, of which min(j, k - 1) drafts
        # survive (d(k) was never fed back).
        self._draft_fed[slot] = base_len + 1 + min(j, k - 1)
        # Target rollback, before any emit can finish the request and
        # donate its pages: the length rewinds to the accept boundary.
        self._lens[slot] = base_len + 1 + j
        # The device cur holds no accepted token: the slot's next decode
        # row feeds its true last token from the host and re-seeds cur.
        self._spec_stale_cur.add(slot)
        req.spec_drafted += k
        req.spec_accepted += j
        self._ring.update(req.request_id, spec_drafted=req.spec_drafted,
                          spec_accepted=req.spec_accepted)
        emitted = drafts[:j] + [row_ver[j]]
        for tok in emitted:
            self._emit(req, slot, int(tok), burst=len(emitted))
            if req.finished_at is not None:
                break  # EOS or a limit inside the burst: drop the tail

    def _drop_inflight(self, slot: int, n: int) -> None:
        left = self._inflight_tokens.get(slot, 0) - n
        if left > 0:
            self._inflight_tokens[slot] = left
        else:
            self._inflight_tokens.pop(slot, None)

    def _emit(self, req: Request, slot: int, tok: int,
              burst: int = 1) -> None:
        """Record one generated token; finish and free the slot if done.
        ``burst`` > 1: one of several tokens a single verify step
        emitted; the round's wall gap is split evenly across the burst,
        so the ITL histogram stays a per-token partition of decode
        time."""
        now = time.monotonic()
        if req.last_token_at is not None:
            gap = (now - req.last_token_at) / max(burst, 1)
            req.max_itl_s = max(req.max_itl_s, gap)
        req.last_token_at = now
        req.tokens.append(tok)
        req.stream.put(tok)
        self._tokens_out += 1
        self._ring.update(req.request_id, generated_tokens=len(req.tokens))
        eos = self.config.eos_id is not None and tok == self.config.eos_id
        if (eos or len(req.tokens) >= req.max_new_tokens
                or len(req.prompt) + len(req.tokens)
                >= self.config.max_seq_len):
            cause = ("eos" if eos
                     else "max_new_tokens"
                     if len(req.tokens) >= req.max_new_tokens
                     else "max_seq_len")
            # KV is written for prompt + generated minus the last
            # sampled token (it was never fed back): exactly the prefix
            # a later request can resume from.
            seq = req.prompt + req.tokens
            self._release_slot(slot, cache_tokens=seq[:len(seq) - 1])
            req.finished_at = now
            self._observe_request(req, state=_reqev.FINISHED, cause=cause)
            req.stream.put(_DONE)

    def _release_slot(self, slot: int, *,
                      cache_tokens: Optional[List[int]] = None) -> None:
        """Return a slot and its pages to the free pools (finish, cancel
        and shutdown paths alike).

        With the prefix cache on: borrowed pages go back to the index
        (refcount -1, never the free list), and on the FINISH path only
        (``cache_tokens`` = the KV-written token sequence) the slot's
        full pages are offered to the trie; pages the trie adopts stay
        cached, the rest are freed.  Cancel and failure paths pass no
        cache_tokens: their tail pages may be partially written, so
        nothing is donated, and neither does a draining engine."""
        self._slot_req.pop(slot, None)
        aid = self._slot_adapter.pop(slot, "")
        if aid:
            self._adapters.release(aid)
        self._free_slots.append(slot)
        self._auditor.mark_dirty()
        if not self._paged:
            # A dense slot owns no pages, and its cache row keeps its
            # length until the next prefill overwrites it.
            self._state_dirty = True
            return
        if self._spec_on:
            self._spec_inflight.discard(slot)
            self._spec_stale_cur.discard(slot)
            self._draft_fed.pop(slot, None)
            dpages = self._draft_slot_pages.pop(slot, None)
            if dpages:
                if _audit.corrupt(_audit.INJECT_DRAFT_PAGE):
                    dpages = dpages[1:]  # leak one draft page
                self._draft_free.extend(dpages)
                self._draft_bt[slot] = self._draft_pages
        pages = self._slot_pages.pop(slot, [])
        if self._prefix is not None:
            borrowed = self._slot_borrowed.pop(slot, [])
            release = borrowed
            if borrowed and _audit.corrupt(_audit.INJECT_TRIE_REF):
                release = borrowed[1:]  # leak one trie borrow ref
            self._prefix.release(release)
            adopted: set = set()
            if cache_tokens is not None and not self._draining.is_set():
                full = len(cache_tokens) // self.config.page_size
                adopted = self._prefix.insert(cache_tokens, pages[:full])
            self._free_pages.extend(p for p in pages[len(borrowed):]
                                    if p not in adopted)
        else:
            self._free_pages.extend(pages)
        self._bt[slot] = self._num_pages
        self._lens[slot] = 0
        self._state_dirty = True
        self._update_page_gauges()

    def _slo_met(self, req: Request) -> bool:
        """Did a FINISHED request meet every configured bound?  (No slo
        config = met; callers gate on the terminal state.)"""
        slo = self.config.slo
        if slo is None:
            return True
        if slo.ttft_s is not None and (
                req.ttft_s is None or req.ttft_s > slo.ttft_s):
            return False
        if slo.tpot_s is not None:
            if req.first_token_at is None or len(req.tokens) < 2:
                return False
            tpot = ((req.finished_at - req.first_token_at)
                    / (len(req.tokens) - 1))
            if tpot > slo.tpot_s:
                return False
        if slo.e2e_s is not None and (
                req.finished_at - req.submitted_at) > slo.e2e_s:
            return False
        return True

    def _observe_request(self, req: Request, *,
                         state: str = _reqev.FINISHED,
                         cause: Optional[str] = None) -> None:
        """Terminal accounting for EVERY outcome: the ring's verdict, the
        SLO, goodput and terminal counters, the latency histograms for
        FINISHED only (a cancelled request has no honest TTFT), and the
        request's span tree (queue wait → prefill → decode) when tracing
        is on, recorded after the fact from the monotonic stamps the loop
        takes anyway, so the decode path carries no tracing code."""
        self._ring.record(req.request_id, state,
                          generated_tokens=len(req.tokens),
                          terminal_cause=cause,
                          spec_drafted=req.spec_drafted or None,
                          spec_accepted=(req.spec_accepted
                                         if req.spec_drafted else None))
        finished = state == _reqev.FINISHED
        met = finished and self._slo_met(req)
        if finished and not met and self.config.slo is not None:
            try:
                from ray_tpu_torch.util import flight_recorder
                flight_recorder.trigger("slo_miss",
                                        request_id=req.request_id)
            except Exception:
                pass  # the verdict must not depend on the recorder
        self._tm["terminal"].inc(tags={"state": state})
        self._tm["slo"].inc(tags={"outcome": "met" if met else "missed"})
        self._terminal_tokens += len(req.tokens)
        if met:
            self._good_tokens += len(req.tokens)
        if self._terminal_tokens:
            self._tm["goodput"].set(
                self._good_tokens / self._terminal_tokens)
        log.debug("request %s %s (cause=%s, %d tokens)",
                  req.request_id, state, cause, len(req.tokens))
        if finished:
            if req.ttft_s is not None:
                self._tm["ttft"].observe(req.ttft_s)
            if req.first_token_at is not None and len(req.tokens) > 1:
                self._tm["tpot"].observe(
                    (req.finished_at - req.first_token_at)
                    / (len(req.tokens) - 1))
                self._tm["itl"].observe(req.max_itl_s)
        # The waterfall: partition this request's e2e wall into the
        # raytpu_serve_request_overhead_seconds components and fold it
        # into the control-plane share (this engine's row only).
        # Best-effort accounting, but never silent.
        try:
            from ray_tpu_torch.serve import latency_attribution as _lat
            row = self._ring.row(req.request_id)
            if row is not None:
                _lat.observe_terminal(req.request_id, rows=[row])
        except Exception:
            log.exception("waterfall of request %s failed", req.request_id)
        if not tracing.is_enabled():
            return
        # Monotonic stamps → wall clock for the trace view.
        off = time.time() - time.monotonic()
        root = tracing.record_span(
            "llm.request", req.submitted_at + off, req.finished_at + off,
            ctx=req.trace_ctx,
            attributes={"request_id": req.request_id,
                        "state": state,
                        "terminal_cause": cause,
                        "prompt_len": len(req.prompt),
                        "num_tokens": len(req.tokens)})
        ctx = {"trace_id": root["trace_id"], "span_id": root["span_id"]}
        # A never-admitted terminal (cancelled or failed in the queue)
        # spends its whole life in queue_wait.
        admitted = req.admitted_at or req.finished_at
        tracing.record_span("llm.queue_wait", req.submitted_at + off,
                            admitted + off, ctx=ctx)
        if req.first_token_at is not None:
            tracing.record_span("llm.prefill", admitted + off,
                                req.first_token_at + off, ctx=ctx)
            tracing.record_span("llm.decode", req.first_token_at + off,
                                req.finished_at + off, ctx=ctx,
                                attributes={"tokens": len(req.tokens)})

    def _admission_queue_age(self) -> float:
        """Seconds since the oldest still-unadmitted request was
        submitted (0.0 when nothing waits).  A snapshot of the waiting
        queue's and the backlog's internals: both only hold Request
        objects, and a stale read shifts the gauge one sample."""
        oldest = None
        for req in list(self._waiting.queue) + (
                list(self._backlog) if self._paged else []):
            if oldest is None or req.submitted_at < oldest:
                oldest = req.submitted_at
        return 0.0 if oldest is None else time.monotonic() - oldest

    def _note_step_time(self, wall_s: float, chunk: int) -> bool:
        """Record an entry's dispatch-to-fetch wall as per-step cost;
        returns True (and logs a warning) when the step blows past
        STALL_FACTOR x its running median over the last 64 entries, so a
        slow ramp moves the baseline while a one-off stall stands
        out."""
        per_step = wall_s / max(chunk, 1)
        history = sorted(self._step_walls)
        self._step_walls.append(per_step)
        if per_step > self._step_wall_hw:
            self._step_wall_hw = per_step
            self._tm["step_wall"].set(per_step)
        if len(history) < 8:
            return False
        median = history[len(history) // 2]
        if median > 0 and per_step > STALL_FACTOR * median:
            log.warning(
                "decode step stall: %.1f ms/step vs running median "
                "%.1f ms (x%.1f, chunk=%d, active=%d)",
                per_step * 1e3, median * 1e3, per_step / median,
                chunk, len(self._slot_req))
            self._stall_events += 1
            return True
        return False

    def _process_cancels(self) -> None:
        with self._cancel_lock:
            if not self._cancels:
                return
            pending = set(self._cancels)
            self._cancels.clear()

        def finish(req: Request, slot: Optional[int]) -> None:
            if slot is not None:
                self._release_slot(slot)
            req.finished_at = time.monotonic()
            self._observe_request(req, state=_reqev.CANCELLED,
                                  cause="cancelled")
            req.stream.put(_DONE)

        for slot, req in list(self._slot_req.items()):
            if req.request_id in pending:
                pending.discard(req.request_id)
                finish(req, slot)
        for st in list(self._prefilling):
            if st["req"].request_id in pending:
                pending.discard(st["req"].request_id)
                self._prefilling.remove(st)
                finish(st["req"], st["slot"])
        for req in list(self._backlog):
            if req.request_id in pending:
                pending.discard(req.request_id)
                self._backlog.remove(req)
                finish(req, None)
        if pending:
            kept: List[Request] = []
            while True:
                try:
                    req = self._waiting.get_nowait()
                except queue.Empty:
                    break
                if req.request_id in pending:
                    finish(req, None)
                else:
                    kept.append(req)
            for req in kept:
                self._waiting.put(req)

    def _preempt_request(self, req: Request, slot: Optional[int]) -> None:
        """Evict one request with a PREEMPTED terminal.  Its stream ends
        by raising PreemptedError carrying the continuation, so the
        consumer knows exactly which generated prefix it holds: tokens
        of its steps still in flight are dropped at fetch (its
        finished_at is set)."""
        if slot is not None:
            self._release_slot(slot)
        req.finished_at = time.monotonic()
        self._observe_request(req, state=_reqev.PREEMPTED,
                              cause="preempted")
        self._preempted_count += 1
        req.stream.put(PreemptedError(
            "replica draining: request evicted",
            continuation={"prompt": list(req.prompt),
                          "tokens": list(req.tokens),
                          "temperature": req.temperature,
                          "request_id": req.request_id,
                          "adapter_id": req.adapter_id}))

    def _process_drain(self) -> None:
        """The loop's half of drain(): while draining, requests that
        never reached a slot are preempted at once (admission has
        stopped); once the grace window has passed (_drain_evict),
        everything still in a slot goes too, and one deep audit follows,
        so a drained engine provably hands back a leak-free pool."""
        if not self._draining.is_set():
            return
        while True:
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                break
            self._preempt_request(req, None)
        for req in list(self._backlog):
            self._backlog.remove(req)
            self._preempt_request(req, None)
        if not self._drain_evict.is_set():
            return
        for st in list(self._prefilling):
            self._prefilling.remove(st)
            self._preempt_request(st["req"], st["slot"])
        for slot, req in list(self._slot_req.items()):
            self._preempt_request(req, slot)
        if not self._drain_audited:
            self._drain_audited = True
            # Open migration leases belong to exports that can no longer
            # complete against a draining engine: release them before the
            # audit, which would rightly call a pinned page a leak.
            self._release_open_leases()
            try:
                self._auditor.run(deep=True)
            except Exception:
                log.exception("drain-evict audit failed")

    def _process_audits(self) -> None:
        """Run queued doctor() ops on the loop thread, the only thread
        allowed to walk slot and page state while the engine runs."""
        with self._audit_lock:
            if not self._audit_ops:
                return
            ops, self._audit_ops = self._audit_ops, []
        for op in ops:
            try:
                op["result"] = self._auditor.run(deep=op["deep"])
            except Exception as e:
                op["error"] = e
            op["done"].set()

    # -- KV page migration (serve/kv_transfer) ------------------------------

    def _migration_op(self, kind: str, timeout_s: float, **kw) -> Any:
        """Queue one migration verb for the loop thread, the only one that
        touches the pool, and wait for its result; re-raises whatever the
        verb raised there."""
        if not self._paged or self._prefix is None:
            raise RuntimeError(
                "KV migration requires the paged engine with "
                "EngineConfig.prefix_cache=True (transfers are keyed "
                "by the prefix trie's chained path hashes)")
        op: Dict[str, Any] = {"kind": kind, "done": threading.Event(),
                              "result": None, "error": None,
                              "abandoned": False, **kw}
        with self._mig_lock:
            # Under the lock the stop path drains the queue with: an op
            # queued after that drain would wait out its whole timeout.
            if self._stopped.is_set():
                raise RuntimeError("engine stopped")
            self._mig_ops.append(op)
        self._work.set()
        if not op["done"].wait(timeout_s):
            with self._mig_lock:
                if not op["done"].is_set():
                    # Still queued: pull it so the loop never runs it.
                    # Already running: flag it abandoned, so the loop
                    # releases a lease nobody will own (a leaked lease
                    # pins its pages against eviction for good).
                    try:
                        self._mig_ops.remove(op)
                    except ValueError:
                        op["abandoned"] = True
                    raise TimeoutError(
                        f"migration op {kind!r} not serviced within "
                        f"{timeout_s}s")
            # done was set between the wait's expiry and the lock: the op
            # completed and its result is usable.
        if op["error"] is not None:
            raise op["error"]
        return op["result"]

    def migration_lease(self, tokens: List[int], *,
                        timeout_s: float = 30.0) -> Optional[dict]:
        """Pin the longest cached full-page prefix of ``tokens`` under an
        eviction-proof migration lease.  Returns ``{"lease_id", "pages",
        "tokens"}`` (tokens cut to the leased depth), or None when not
        even one full page is cached.  The caller owns the lease and MUST
        ``migration_release`` it on every path."""
        return self._migration_op("lease", timeout_s,
                                  tokens=[int(t) for t in tokens])

    def migration_export(self, lease_id: str, *, mode: str = "int8",
                         timeout_s: float = 30.0) -> dict:
        """Serialise a leased page run into one transfer dict (the
        kv_transfer.encode_pages wire format: payload, per-page int8
        scales, chained path hashes and analytic wire bytes)."""
        return self._migration_op("export", timeout_s,
                                  lease_id=lease_id, mode=mode)

    def migration_release(self, lease_id: str, *,
                          timeout_s: float = 30.0) -> bool:
        """Drop a migration lease.  Idempotent: an unknown id returns
        False, so clean-up never raises over a lease already gone."""
        return self._migration_op("release", timeout_s, lease_id=lease_id)

    def migration_ingest(self, transfer: dict, *,
                         timeout_s: float = 30.0) -> int:
        """Ingest one transfer into the local pool and prefix trie:
        verify its content identity (chained CRC32 over the tokens), skip
        depths already cached, scatter the payload into freshly allocated
        pages and insert them into the trie.  Cut to the free-page budget
        so the ingested prefix stays contiguous from the root.  Returns
        the number of pages ingested."""
        return self._migration_op("ingest", timeout_s, transfer=transfer)

    def export_hot_prefixes(self, *, max_pages: int = 256,
                            mode: str = "int8",
                            timeout_s: float = 60.0) -> List[dict]:
        """Prefix migration, source side: lease, export and release each
        hot cached path (recency order, deduplicated); a cold or new
        engine ingests the transfers instead of recomputing its cache.
        Each path ships once (``hot_paths(distinct=True)``), where the
        JAX engine ships one transfer per depth of a path."""
        return self._migration_op("hot_prefixes", timeout_s,
                                  max_pages=max_pages, mode=mode)

    def _fail_migration_ops(self, error: Callable[[dict], Exception]) -> None:
        with self._mig_lock:
            ops, self._mig_ops = self._mig_ops, []
        for op in ops:
            op["error"] = error(op)
            op["done"].set()

    def _process_migrations(self) -> None:
        if self._prefix is None:
            return
        if self._mig_staging:
            # Ingest buffers whose host→device copy has completed.
            self._mig_staging = [(buf, ev) for buf, ev in self._mig_staging
                                 if not ev.query()]
        with self._mig_lock:
            if not self._mig_ops:
                return
            ops, self._mig_ops = self._mig_ops, []
        handlers = {"lease": self._mig_do_lease,
                    "export": self._mig_do_export,
                    "release": self._mig_do_release,
                    "ingest": self._mig_do_ingest,
                    "hot_prefixes": self._mig_do_hot_prefixes}
        for op in ops:
            try:
                op["result"] = handlers[op["kind"]](op)
            except Exception as e:  # re-raised at the waiter; loop lives
                op["error"] = e
            with self._mig_lock:
                # A waiter that timed out while the op ran marked it
                # abandoned: nobody reads the result, so a lease taken
                # here would leak; drop it now.  The lock orders this
                # against the waiter's flag.
                if (op["abandoned"] and op["kind"] == "lease"
                        and op.get("result") is not None):
                    self._mig_do_release(
                        {"lease_id": op["result"]["lease_id"]})
                    op["result"] = None
                op["done"].set()

    def _mig_do_lease(self, op: dict) -> Optional[dict]:
        page = self.config.page_size
        pages = self._prefix.lease_acquire(op["tokens"])
        if not pages:
            return None
        lease_id = f"mig-{self._engine_id}-{next(self._mig_lease_ids)}"
        self._mig_leases[lease_id] = {
            "pages": list(pages),
            "tokens": op["tokens"][:len(pages) * page]}
        return {"lease_id": lease_id, "pages": list(pages),
                "tokens": list(self._mig_leases[lease_id]["tokens"])}

    def _mig_gather(self, pages: List[int]) -> Dict[str, np.ndarray]:
        """Every layer's copy of ``pages`` as host arrays (a bf16 pool's
        widened exactly to f32 on the device): index_select over the page
        axis (axis 1 for int8 scales) on the engine's stream, then ONE
        device→host copy of the parts as one byte buffer.  The copy waits
        for the stream, so every step already queued has written its
        pages; the verb's caller waits for it anyway."""
        ids = self._h2d(np.asarray(pages, np.int64))
        parts: Dict[str, torch.Tensor] = {}
        for key in ("k", "v", "k_scale", "v_scale"):
            if key not in self._cache:
                continue
            t = torch.index_select(self._cache[key], 2 if key in ("k", "v")
                                   else 1, ids)
            if t.is_floating_point() and t.dtype != torch.float32:
                t = t.float()
            parts[key] = t
        host = torch.cat([t.reshape(-1).view(torch.uint8)
                          for t in parts.values()]).cpu().numpy()
        out, at = {}, 0
        for key, t in parts.items():
            n = t.numel() * t.element_size()
            dt = np.int8 if t.dtype == torch.int8 else np.float32
            out[key] = host[at:at + n].view(dt).reshape(tuple(t.shape))
            at += n
        return out

    def _mig_do_export(self, op: dict) -> dict:
        from ray_tpu_torch.serve import kv_transfer as _kvt

        lease = self._mig_leases.get(op["lease_id"])
        if lease is None:
            raise KeyError(f"unknown migration lease {op['lease_id']!r}")
        t0 = time.monotonic()
        pages = lease["pages"]
        transfer = _kvt.encode_pages(
            self._mig_gather(pages), tokens=lease["tokens"],
            page_size=self.config.page_size, mode=op["mode"],
            src_dtype=str(self._cache["k"].dtype).replace("torch.", ""))
        n = len(pages)
        self._mig_counts["pages_out"] += n
        self._mig_counts["bytes_out"] += transfer["wire_bytes"]
        self._tm["mig_pages"].inc(n, tags={"direction": "out"})
        self._tm["mig_bytes"].inc(transfer["wire_bytes"],
                                  tags={"direction": "out"})
        self._tm["mig_seconds"].observe(time.monotonic() - t0,
                                        tags={"op": "export"})
        return transfer

    def _mig_do_release(self, op: dict) -> bool:
        lease = self._mig_leases.pop(op["lease_id"], None)
        if lease is None:
            return False
        self._prefix.lease_release(lease["pages"])
        return True

    def _mig_scatter(self, dst: List[int],
                     payload: Dict[str, torch.Tensor]) -> None:
        """Write ``payload`` (host tensors in the pool's layout and dtype)
        into pages ``dst`` with index_copy_ on the engine's stream.  On
        the card the payload goes through ONE pinned buffer (segments on
        16-byte boundaries) and a non-blocking copy, so the scatter lands
        after every step already queued, as the JAX engine's data
        dependency on the donated cache orders it; the buffer is kept
        until an event recorded after the copy has completed."""
        ids = self._h2d(np.asarray(dst, np.int64))
        axes = {"k": 2, "v": 2, "k_scale": 1, "v_scale": 1}
        if self.device.type != "cuda":
            for key, t in payload.items():
                self._cache[key].index_copy_(axes[key], ids, t)
            return
        sizes = {k: t.numel() * t.element_size() for k, t in payload.items()}
        offs, at = {}, 0
        for key, n in sizes.items():
            offs[key] = at
            at += -(-n // 16) * 16
        buf = torch.empty((at,), dtype=torch.uint8, pin_memory=True)
        for key, t in payload.items():
            buf[offs[key]:offs[key] + sizes[key]].copy_(
                t.contiguous().reshape(-1).view(torch.uint8))
        dev = buf.to(self.device, non_blocking=True)
        for key, t in payload.items():
            src = dev[offs[key]:offs[key] + sizes[key]].view(t.dtype)
            self._cache[key].index_copy_(axes[key], ids, src.view(t.shape))
        event = torch.cuda.Event()
        event.record()
        self._mig_staging.append((buf, event))

    def _mig_do_ingest(self, op: dict) -> int:
        from ray_tpu_torch.serve import kv_transfer as _kvt

        transfer = op["transfer"]
        page = self.config.page_size
        if int(transfer["page_size"]) != page:
            raise ValueError(
                f"transfer page_size {transfer['page_size']} != local "
                f"pool page_size {page}")
        _kvt.verify_transfer(transfer)
        t0 = time.monotonic()
        tokens = [int(t) for t in transfer["tokens"]]
        n_full = len(tokens) // page
        # Depths the trie already holds keep their local pages.  The
        # borrow is held across the eviction AND the insert: evict()
        # reclaims any refcount-0 page, so releasing the hit first could
        # free pages the insert is about to adopt again.
        hit = self._prefix.acquire(tokens)
        try:
            have = len(hit)
            need = n_full - have
            if need <= 0:
                return 0
            if len(self._free_pages) < need:
                freed = self._prefix.evict(need - len(self._free_pages))
                self._free_pages.extend(freed)
                if freed:
                    self._tm["prefix_evicted"].inc(len(freed))
            # Cut, never reorder: the ingested prefix must stay contiguous
            # from the root or the hashes stop naming a path.
            need = min(need, len(self._free_pages))
            if need <= 0:
                return 0
            dst = [self._free_pages.pop() for _ in range(need)]
            payload = _kvt.decode_payload(
                transfer, "k_scale" in self._cache, self._cache["k"].dtype,
                start_page=have, end_page=have + need)
            self._mig_scatter(dst, payload)
            adopted = self._prefix.insert(tokens[:(have + need) * page],
                                          hit + dst)
            for p in dst:
                if p not in adopted:  # lost a race with a local insert
                    self._free_pages.append(p)
            n_in = sum(1 for p in dst if p in adopted)
        finally:
            if hit:
                self._prefix.release(hit)
        wire = int(transfer.get("wire_bytes", 0))
        self._mig_counts["pages_in"] += n_in
        self._mig_counts["bytes_in"] += wire
        self._tm["mig_pages"].inc(n_in, tags={"direction": "in"})
        self._tm["mig_bytes"].inc(wire, tags={"direction": "in"})
        self._tm["mig_seconds"].observe(time.monotonic() - t0,
                                        tags={"op": "ingest"})
        self._update_page_gauges()
        return n_in

    def _mig_do_hot_prefixes(self, op: dict) -> List[dict]:
        out: List[dict] = []
        for path in self._prefix.hot_paths(op["max_pages"], distinct=True):
            lease = self._mig_do_lease({"tokens": path["tokens"]})
            if lease is None:
                continue
            try:
                out.append(self._mig_do_export(
                    {"lease_id": lease["lease_id"], "mode": op["mode"]}))
            finally:
                self._mig_do_release({"lease_id": lease["lease_id"]})
        return out

    def _release_open_leases(self) -> None:
        """Drop every open migration lease (stop and drain-evict): a lease
        still open here belongs to a client whose export can no longer
        complete, and it would pin its pages against eviction for good."""
        if self._prefix is None or not self._mig_leases:
            return
        for lease_id in list(self._mig_leases):
            lease = self._mig_leases.pop(lease_id)
            try:
                self._prefix.lease_release(lease["pages"])
            except Exception:
                log.exception("migration lease %s did not release "
                              "cleanly during stop or drain", lease_id)

    # -- loop --------------------------------------------------------------

    def _loop(self) -> None:
        try:
            with torch.no_grad():
                self._loop_body()
        except BaseException as e:  # engine crash — fail every client
            self._stopped.set()
            # A loop that died mid-dispatch strands allocator state: that
            # is no leak for an audit to report.
            self._crashed = True
            log.exception("torch LLM engine loop crashed")
            self._fail_migration_ops(
                lambda op: RuntimeError(
                    f"engine crashed before migration op {op['kind']!r} "
                    f"ran: {e!r}"))
            with self._audit_lock:  # release doctor() waiters too
                audit_ops, self._audit_ops = self._audit_ops, []
            for op in audit_ops:
                op["error"] = RuntimeError(
                    f"engine crashed before audit ran: {e!r}")
                op["done"].set()
            self._fail_all(RuntimeError(f"LLM engine loop crashed: {e!r}"),
                           cause=repr(e))
            raise
        # A clean stop ends queued migration ops at once (no waiter hangs
        # until its timeout), releases every open lease, fails what still
        # runs and releases every slot (pages, adapter borrows, draft
        # pages, borrowed prefix pages) before the final deep audit, so
        # anything the audit finds is an accounting fault, not an
        # artefact of stopping mid-flight.
        self._fail_migration_ops(
            lambda op: RuntimeError(
                f"engine stopped before migration op {op['kind']!r} ran"))
        self._release_open_leases()
        for _buf, event in self._mig_staging:
            event.synchronize()  # no pinned buffer dies under its copy
        self._mig_staging.clear()
        self._fail_all(RuntimeError("engine shut down"),
                       cause="engine shut down")
        self._process_audits()  # queued doctor() ops still get served
        try:
            self._auditor.run(deep=True)
        except Exception:
            log.exception("final shutdown audit failed")

    def _fail_all(self, err: BaseException, cause: str) -> None:
        failing = list(self._slot_req.values()) + list(self._admitting)
        failing += [st["req"] for st in self._prefilling]
        failing += list(self._backlog)
        while True:
            try:
                failing.append(self._waiting.get_nowait())
            except queue.Empty:
                break
        seen = set()
        for req in failing:
            if id(req) in seen or req.finished_at is not None:
                continue
            seen.add(id(req))
            req.finished_at = time.monotonic()
            try:
                # FAILED accounting (ring, counters, spans); the stream
                # must get its error whatever the accounting does.
                self._observe_request(req, state=_reqev.FAILED, cause=cause)
            except Exception:
                log.exception("FAILED accounting of %s", req.request_id)
            req.stream.put(err)
        leftovers = set(self._slot_req)
        leftovers.update(st["slot"] for st in self._prefilling)
        self._prefilling.clear()
        for slot in sorted(leftovers):
            self._release_slot(slot)

    def _loop_body(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stopped.is_set():
            self._process_cancels()
            self._process_drain()
            self._process_migrations()
            self._process_audits()
            if (not self._slot_req and not self._prefilling
                    and self._waiting.empty() and not self._backlog
                    and not self._pending):
                # Idle: settle the incremental audit, and now and then a
                # deep one (idle is when a full walk costs nobody).
                self._auditor.maybe_incremental()
                if not self._draining.is_set():
                    self._auditor.maybe_idle_deep(time.monotonic())
                self._work.wait(timeout=0.05)
                self._work.clear()
                continue
            self._process_fetched(block=False)
            if self._draining.is_set():
                pass  # racing submits are preempted, never admitted
            elif self._ragged:
                self._admit_ragged()
            elif self._paged:
                self._admit_paged()
            else:
                self._admit_dense()
            self._auditor.maybe_incremental()
            # Enqueueing a step costs tens of ms of host time in eager
            # PyTorch: deliver the first tokens of a fresh admission
            # before it, not after.
            while any(e.carries_first_tokens for e in self._pending):
                self._process_fetched(block=True)
            dispatched = False
            if self._ragged:
                if ((self._slot_req or self._prefilling)
                        and len(self._pending) < self._PIPELINE_DEPTH):
                    dispatched = self._dispatch_ragged_step()
            else:
                if (self._prefilling
                        and len(self._pending) < self._PIPELINE_DEPTH):
                    # One prompt chunk per iteration rides the device
                    # queue BETWEEN decode chunks.
                    self._dispatch_prefill_chunk()
                    dispatched = True
                if (self._slot_req
                        and len(self._pending) < self._PIPELINE_DEPTH):
                    chunk = self._chunk_size()
                    if chunk > 0:
                        self._dispatch_decode(chunk)
                        dispatched = True
            if not dispatched and self._pending:
                self._process_fetched(block=True)
