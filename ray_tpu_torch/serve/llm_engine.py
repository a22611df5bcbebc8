"""Continuous-batching LLM engine on the paged KV cache (port of
``ray_tpu/serve/llm_engine.py``, its paged path: bucketed, chunked and
ragged).

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
kernels write into it).  One loop thread does all device work; client
threads only submit, cancel and read their streams.

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

Out of the port so far (they raise if configured): speculative decoding,
LoRA, SLO accounting and shedding, migration, the request ring,
telemetry, the audit plane and ``LLMServer``.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.ragged_paged_attention import pack_ragged_batch

log = logging.getLogger(__name__)


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
    # slo, shed_queue_age_s and every field from adapter_pool_pages on
    # belong to modes the port does not have yet: each must keep its
    # default (see _UNPORTED).
    slo: Optional[Any] = None
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
    adapter_pool_pages: int = 0
    adapter_page_elems: int = 8192
    max_batch_adapters: int = 8
    adapter_int8: bool = False
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


_UNPORTED = {
    "slo": "SLO accounting",
    "shed_queue_age_s": "overload shedding",
    "adapter_pool_pages": "LoRA multiplexing",
    "adapter_page_elems": "LoRA multiplexing",
    "max_batch_adapters": "LoRA multiplexing",
    "adapter_int8": "LoRA multiplexing",
    "spec_decode": "speculative decoding",
    "spec_k": "speculative decoding",
    "spec_draft_pages": "speculative decoding",
    "spec_cold_accept": "speculative decoding",
    "spec_cooldown_rounds": "speculative decoding",
}


def _check_ported(config: EngineConfig) -> None:
    defaults = EngineConfig()
    for field, mode in _UNPORTED.items():
        if getattr(config, field) != getattr(defaults, field):
            raise NotImplementedError(
                f"EngineConfig.{field}: {mode} is not ported to "
                "ray_tpu_torch yet (a later slice; see ROADMAP.md)")


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
    """

    init_cache: Callable[[int, int, torch.device], Any]
    prefill_slot: Callable[..., Tuple[torch.Tensor, Any]]
    decode_slots: Callable[..., Tuple[torch.Tensor, Any, torch.Tensor]]
    prefill_batch: Callable[..., Tuple[torch.Tensor, Any]]
    prefill_chunk: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    ragged_step: Optional[Callable[..., Tuple[torch.Tensor, Any]]] = None
    copy_page: Optional[Callable[[Any, int, int], Any]] = None


def llama_paged_adapter(cfg) -> PagedEngineAdapter:
    from ray_tpu_torch.models import llama

    return PagedEngineAdapter(
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
        ragged_step=lambda params, tokens, tok_pos, row_slot, row_start,
        row_len, row_off, bt, cache:
            llama.ragged_step_paged(params, tokens, tok_pos, row_slot,
                                    row_start, row_len, row_off, bt, cfg,
                                    cache),
        copy_page=llama.copy_page_paged,
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
    request_id: str = ""
    # Prompt tokens served from the prefix cache (0 = cold prefill).
    prefix_hit: int = 0

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

    @property
    def carries_first_tokens(self) -> bool:
        return self.kind == "prefill" or (
            self.kind == "ragged"
            and any(part[0] == "first" for part in self.participants))


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
    chunked prefill or the ragged unified step when configured."""

    # Dispatched-but-unemitted entries: enough to keep the device busy
    # while the host processes tokens; budget gating bounds run-ahead.
    _PIPELINE_DEPTH = 6

    def __init__(self, params: Any, adapter: PagedEngineAdapter,
                 config: EngineConfig, *, seed: int = 0,
                 device: DeviceLike = None):
        _check_ported(config)
        self.config = config
        self.adapter = adapter
        self.device = resolve_device(device)
        pdev = _tensor_device(params)
        if pdev is not None and pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, engine device is "
                             f"{self.device}")
        self._params = params
        page = config.page_size
        self._ragged = bool(config.ragged_batching)
        if self._ragged:
            if adapter.ragged_step is None:
                raise ValueError("EngineConfig.ragged_batching requires a "
                                 "PagedEngineAdapter with ragged_step")
            self._token_budget = config.token_budget or (
                config.max_slots + max(config.prefill_chunk, page))
            if self._token_budget < config.max_slots + 1:
                raise ValueError(
                    "token_budget must leave room for a prefill chunk "
                    f"beside {config.max_slots} decode rows")
        self._chunked = (not self._ragged and config.prefill_chunk > 0
                         and adapter.prefill_chunk is not None)
        self._maxp = -(-config.max_seq_len // page)
        self._num_pages = config.num_pages or config.max_slots * self._maxp
        self._cache = adapter.init_cache(self._num_pages, page, self.device)
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
        self._free_pages = list(range(self._num_pages))
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
        self._prefix_hit_tokens = 0
        self._prefix_prompt_tokens = 0
        # Unallocated block-table entries hold the OOB sentinel
        # (num_pages, the scratch page): never read by attention, and a
        # slot decoded past its allocation writes only scratch.
        self._bt = np.full((config.max_slots, self._maxp), self._num_pages,
                           np.int32)
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
        self._stopped = threading.Event()
        self._work = threading.Event()
        self._steps = 0
        self._tokens_out = 0
        self._admitting: List[Request] = []
        self._cancel_lock = threading.Lock()
        self._cancels: set = set()
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
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine-torch")
        self._thread.start()

    # -- client API --------------------------------------------------------

    def submit(self, prompt: List[int], *,
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               request_id: Optional[str] = None) -> CompletionStream:
        if self._stopped.is_set():
            raise RuntimeError("engine is stopped (shut down or crashed)")
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
            req_id=next(self._req_counter))
        req.request_id = request_id or f"torch-engine-r{req.req_id}"
        # Reject requests the page pool can NEVER satisfy — they would
        # otherwise wedge admission head-of-line forever.
        need = self._pages_needed(req)
        if need > self._num_pages:
            raise ValueError(
                f"request needs {need} pages ({len(prompt)}+"
                f"{req.max_new_tokens} tokens, page "
                f"{self.config.page_size}) but the pool has only "
                f"{self._num_pages}")
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

    def stats(self) -> Dict[str, Any]:
        out = {"device": str(self.device),
               "active_slots": self.config.max_slots - len(self._free_slots),
               "waiting": self._waiting.qsize() + len(self._backlog),
               "prefilling": len(self._prefilling),
               "steps": self._steps,
               "tokens_out": self._tokens_out,
               # Tokens dispatched to the device by phase (prefill
               # padding rows included), and ragged steps that packed
               # decode rows beside prompt tokens.
               "step_tokens": dict(self._step_tokens),
               "mixed_steps": self._mixed_steps,
               "kv_pages_free": len(self._free_pages),
               "kv_pages_cached": (self._prefix.cached_pages
                                   if self._prefix else 0)}
        if self._prefix is not None:
            pstats = self._prefix.stats()
            pstats["hit_tokens"] = self._prefix_hit_tokens
            pstats["prompt_tokens"] = self._prefix_prompt_tokens
            out["prefix"] = pstats
        return out

    def prefix_summary(self, max_entries: int = 256) -> Optional[dict]:
        """Compact routing summary of the prefix cache ({"page": …,
        "hashes": [chained CRC32 path hashes]}), or None when the cache
        is off."""
        if self._prefix is None:
            return None
        return self._prefix.summary(max_entries)

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
            self._free_pages.extend(
                self._prefix.evict(need - len(self._free_pages)))
        if len(self._free_pages) < need:
            return None
        slot = self._free_slots.pop()
        pages = [self._free_pages.pop() for _ in range(need)]
        self._slot_pages[slot] = pages
        row = np.full((self._maxp,), self._num_pages, np.int32)
        row[: len(pages)] = pages
        self._bt[slot] = row
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
        return slot, start

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

    def _admit_ragged(self) -> None:
        """Ragged admission: EVERY request claims its slot and pages up
        front and joins the incremental track; the unified step packs
        its prompt in budget-sized chunks beside live decode rows, so no
        separate prefill program can block them."""
        while self._free_slots:
            if self._backlog:
                req = self._backlog.pop(0)
            else:
                try:
                    req = self._waiting.get_nowait()
                except queue.Empty:
                    return
            got = self._admit_slot_for(req)
            if got is None:
                self._backlog.insert(0, req)
                return
            slot, start = got
            self._prefilling.append({"req": req, "slot": slot,
                                     "pos": start})
            self._state_dirty = True  # bt rows changed

    def _run_prefill(self, tokens, true_lens, pages_rows, temps,
                     scatter_ids) -> torch.Tensor:
        """One batched prefill; the sampled first tokens scatter into
        the device cur (OOB scatter ids dropped)."""
        # Padding rows are device work too: they count as prefill tokens.
        self._step_tokens["prefill"] += int(np.sum(true_lens))
        logits, self._cache = self.adapter.prefill_batch(
            self._params, self._h2d(tokens), self._h2d(true_lens),
            self._h2d(pages_rows), self._cache)
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
        for req, slot in batch:
            self._slot_req[slot] = req
            self._temps[slot] = req.temperature
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
        steps = []
        for _ in range(chunk):
            logits, self._cache, lens = self.adapter.decode_slots(
                self._params, cur, self._active_dev, self._bt_dev, lens,
                self._cache)
            toks = _sample(logits, self._temps_dev, gen)
            cur = torch.where(self._active_dev, toks, cur)
            steps.append(cur)
        self._cur_dev, self._lens_dev = cur, lens
        # Host mirror advances for slots active in THIS dispatch.
        for slot in self._slot_req:
            self._lens[slot] += chunk
        self._steps += chunk
        self._step_tokens["decode"] += chunk * len(self._slot_req)
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
        self._step_tokens["prefill"] += len(chunk)
        if is_last:
            self._prefilling.pop(0)
            self._cur_dev[slot] = toks[0]
            self._lens[slot] = len(req.prompt)
            self._finish_admit([(req, slot)], toks)
        else:
            self._enqueue_fetch("pfchunk", toks, 0, [])

    # -- ragged unified step -----------------------------------------------

    def _dispatch_ragged_step(self) -> bool:
        """Pack and dispatch ONE unified ragged step: first a decode row
        (one token) for every running slot with budget left, then prompt
        chunks from the incremental track until token_budget is full.
        Decode rows are never displaced by prompt tokens: that priority
        is the no-stall guarantee.  Returns False when nothing fit (every
        slot budget-capped by in-flight tokens, no prompt pending)."""
        T, R = self._token_budget, self.config.max_slots
        budget = T
        rows: List[Dict[str, Any]] = []
        parts: List[Tuple[str, Request, int, int]] = []
        scatter = np.full((R,), R, np.int32)  # R = sample dropped
        temps = np.zeros((R,), np.float32)
        n_decode = n_prefill = 0
        for slot in sorted(self._slot_req):
            if budget <= 0 or len(rows) >= R:
                break
            req = self._slot_req[slot]
            rem = min(req.max_new_tokens - len(req.tokens),
                      self.config.max_seq_len - len(req.prompt)
                      - len(req.tokens)) \
                - self._inflight_tokens.get(slot, 0)
            if rem <= 0:
                continue  # its budget is covered by in-flight steps
            i = len(rows)
            # The token lives on the device (cur): no host round trip.
            rows.append({"slot": slot, "start": int(self._lens[slot]),
                         "tokens": None})
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
            i = len(rows)
            rows.append({"slot": slot, "start": pos,
                         "tokens": [int(t) for t in chunk]})
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
        toks_dev = self._run_ragged(
            pack_ragged_batch(rows, T, R), scatter, temps)
        for kind, req, slot, _i in parts:
            if kind == "decode":
                self._lens[slot] += 1  # the mirror advances at dispatch
            self._inflight_tokens[slot] = \
                self._inflight_tokens.get(slot, 0) + 1
        for st in finishing:
            self._prefilling.remove(st)
            req, slot = st["req"], st["slot"]
            self._lens[slot] = len(req.prompt)
            self._slot_req[slot] = req
            self._temps[slot] = req.temperature
        self._steps += 1
        self._step_tokens["decode"] += n_decode
        self._step_tokens["prefill"] += n_prefill
        if n_decode and n_prefill:
            self._mixed_steps += 1
        self._enqueue_fetch("ragged", toks_dev, 1, parts)
        return True

    def _run_ragged(self, packed, scatter: np.ndarray,
                    temps: np.ndarray) -> torch.Tensor:
        """One ragged step on the device.  The step's host arrays travel
        as ONE int32 buffer (pinned, non-blocking on the card), sliced on
        the device; each slice starts on a 16-byte boundary.  Decode rows
        read their token from the device cur; the row samples scatter
        into cur, dropping scatter id R (mid-prompt and padding rows)."""
        R = self.config.max_slots
        (host_toks, decode_mask, tok_slot, tok_pos, row_slot, row_start,
         row_len, row_off) = packed
        segs = [host_toks, decode_mask.astype(np.int32), tok_slot, tok_pos,
                row_slot, row_start, row_len, row_off, scatter,
                temps.view(np.int32)]
        widths = [-(-len(a) // 4) * 4 for a in segs]
        buf = np.zeros((sum(widths),), np.int32)
        cuts, at = [], 0
        for a, w in zip(segs, widths):
            buf[at:at + len(a)] = a
            cuts.append((at, at + len(a)))
            at += w
        dev = self._h2d(buf)
        (h_toks, d_mask, t_slot, t_pos, r_slot, r_start, r_len, r_off,
         scatter_d, temps_d) = (dev[a:b] for a, b in cuts)
        toks = torch.where(d_mask != 0, self._cur_dev[t_slot.long()], h_toks)
        logits, self._cache = self.adapter.ragged_step(
            self._params, toks, t_pos, r_slot, r_start, r_len, r_off,
            self._bt_dev, self._cache)
        sampled = _sample(logits, temps_d.view(torch.float32),
                          self._gen if (temps > 0).any() else None)
        cur = torch.empty((R + 1,), dtype=torch.int32, device=self.device)
        cur[:R] = self._cur_dev
        cur[scatter_d.long()] = sampled
        self._cur_dev = cur[:R]
        return sampled

    # -- token delivery ----------------------------------------------------

    def _enqueue_fetch(self, kind: str, toks: torch.Tensor, chunk: int,
                       participants) -> None:
        """Start the one device→host copy of a dispatch's tokens."""
        event = None
        if toks.is_cuda:
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = toks
        self._pending.append(_InFlight(kind, host, event, chunk,
                                       participants))

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
            if entry.kind == "pfchunk":
                continue  # a marker: it only gated the pipeline depth
            if entry.kind == "ragged":
                # One unified step: toks is the [R] row-sample vector;
                # the parts are decode rows and last prompt chunks
                # (mid-prompt rows have nothing to emit).
                now = time.monotonic()
                for rkind, req, slot, i in entry.participants:
                    self._drop_inflight(slot, 1)
                    if req.finished_at is not None:
                        continue  # cancelled while in flight
                    if rkind == "first":
                        req.first_token_at = now
                        self._emit(req, slot, int(toks[i]))
                    elif self._slot_req.get(slot) is req:
                        self._emit(req, slot, int(toks[i]))
                continue
            if entry.kind == "prefill":
                for i, (req, slot) in enumerate(entry.participants):
                    self._drop_inflight(slot, 1)
                    if req.finished_at is not None:
                        continue  # cancelled while its prefill ran
                    req.first_token_at = time.monotonic()
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

    def _drop_inflight(self, slot: int, n: int) -> None:
        left = self._inflight_tokens.get(slot, 0) - n
        if left > 0:
            self._inflight_tokens[slot] = left
        else:
            self._inflight_tokens.pop(slot, None)

    def _emit(self, req: Request, slot: int, tok: int) -> None:
        """Record one generated token; finish and free the slot if
        done."""
        req.tokens.append(tok)
        req.stream.put(tok)
        self._tokens_out += 1
        eos = self.config.eos_id is not None and tok == self.config.eos_id
        if (eos or len(req.tokens) >= req.max_new_tokens
                or len(req.prompt) + len(req.tokens)
                >= self.config.max_seq_len):
            # KV is written for prompt + generated minus the last
            # sampled token (it was never fed back): exactly the prefix
            # a later request can resume from.
            seq = req.prompt + req.tokens
            self._release_slot(slot, cache_tokens=seq[:len(seq) - 1])
            req.finished_at = time.monotonic()
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
        nothing is donated."""
        self._slot_req.pop(slot, None)
        self._free_slots.append(slot)
        pages = self._slot_pages.pop(slot, [])
        if self._prefix is not None:
            borrowed = self._slot_borrowed.pop(slot, [])
            self._prefix.release(borrowed)
            adopted: set = set()
            if cache_tokens is not None:
                full = len(cache_tokens) // self.config.page_size
                adopted = self._prefix.insert(cache_tokens, pages[:full])
            self._free_pages.extend(p for p in pages[len(borrowed):]
                                    if p not in adopted)
        else:
            self._free_pages.extend(pages)
        self._bt[slot] = self._num_pages
        self._lens[slot] = 0
        self._state_dirty = True

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

    # -- loop --------------------------------------------------------------

    def _loop(self) -> None:
        try:
            with torch.no_grad():
                self._loop_body()
        except BaseException as e:  # engine crash — fail every client
            self._stopped.set()
            log.exception("torch LLM engine loop crashed")
            self._fail_all(RuntimeError(f"LLM engine loop crashed: {e!r}"))
            raise
        self._fail_all(RuntimeError("engine shut down"))

    def _fail_all(self, err: BaseException) -> None:
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
            if (not self._slot_req and not self._prefilling
                    and self._waiting.empty() and not self._backlog
                    and not self._pending):
                self._work.wait(timeout=0.05)
                self._work.clear()
                continue
            self._process_fetched(block=False)
            if self._ragged:
                self._admit_ragged()
            else:
                self._admit_paged()
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
