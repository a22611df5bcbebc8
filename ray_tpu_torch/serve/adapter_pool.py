"""Paged pool of LoRA adapter weights for multi-tenant serving (port of
``ray_tpu/serve/adapter_pool.py``).

Thousands of fine-tuned variants cannot each be a resident model; each
can be a few pages of LoRA factors.  The pool gives adapter weights the
allocator discipline of the KV cache's page pool:

  * fixed-size pages in one device tensor ``[num_pages + 1, page_elems]``
    (f32, or int8 with a per-page scale, the models/quant.py
    discipline); every adapter takes exactly ``pages_per_adapter`` pages
    (a fixed rank and target set per pool), so the pool never fragments;
  * borrow refcounts while an in-flight row uses an adapter, refcount-0
    LRU eviction under pressure, and release raising on underflow (the
    PrefixIndex contract: a double release is a bug to surface);
  * load-once dedup by content hash: two ids whose flattened factors are
    byte-identical share one page set (one upload, one eviction unit);
  * the LAST page is the never-written all-zero SCRATCH page: the null
    adapter (``adapter_id == ""``) and unused page-table rows gather
    exact zeros, which keeps base-model rows byte-identical to
    adapter-off serving.

The engine loop is the only caller of acquire/release/page_table;
``summary()``/``stats()`` may be read from other threads, so all state
sits behind one lock.  Uploads are stream-ordered copies into the pool,
so a step dispatched before an upload reads the pages as they were.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.quant import quantize_tensor
from ray_tpu_torch.ops import segmented_lora as _sl

_TELEMETRY = None


def _telemetry():
    """Adapter-pool metric singletons, merged into the engine's telemetry
    dict (llm_engine._telemetry) so every family is declared at engine
    construction, before any adapter is loaded; re-registered on later
    fetches so a registry clear() cannot drop them."""
    global _TELEMETRY
    from ray_tpu_torch.util import metrics

    if _TELEMETRY is None:
        _TELEMETRY = {
            "adapter_pool_pages": metrics.Gauge(
                "raytpu_serve_adapter_pool_pages",
                "Fixed-size pages in the LoRA adapter pool (scratch "
                "page excluded)."),
            "adapter_resident": metrics.Gauge(
                "raytpu_serve_adapter_resident",
                "Adapter ids currently resident (backed by loaded "
                "pages; content-deduped ids each count once)."),
            "adapter_hits": metrics.Counter(
                "raytpu_serve_adapter_hits_total",
                "Adapter acquisitions served from resident pages "
                "(same id, or a content-hash dedup against another "
                "id's pages)."),
            "adapter_misses": metrics.Counter(
                "raytpu_serve_adapter_misses_total",
                "Adapter acquisitions that uploaded pages (first "
                "load, or a re-load after eviction)."),
            "adapter_evictions": metrics.Counter(
                "raytpu_serve_adapter_evictions_total",
                "Adapter page-sets evicted (refcount-0 LRU under "
                "pool pressure)."),
        }
    else:
        reg = metrics.registry()
        for m in _TELEMETRY.values():
            reg.register(m)
    return _TELEMETRY


class AdapterPoolPressure(RuntimeError):
    """Transient: every resident adapter is borrowed by an in-flight row,
    so nothing is evictable now.  Callers back off and retry once borrows
    release (the engine re-queues the request)."""


class _Block:
    """One loaded (content-unique) adapter: its page set and borrows."""

    __slots__ = ("pages", "refs", "last_used", "ids")

    def __init__(self, pages: List[int]):
        self.pages = pages
        self.refs = 0
        self.last_used = 0
        self.ids: Set[str] = set()


class AdapterPool:
    def __init__(self, model_cfg: Any, lora_cfg: _sl.LoRAConfig, *,
                 num_pages: int = 0, page_elems: int = 8192,
                 max_batch_adapters: int = 8, int8: bool = False,
                 loader: Optional[Callable[[str], Any]] = None,
                 device: DeviceLike = None):
        if page_elems <= 0:
            raise ValueError(f"page_elems must be positive, got {page_elems}")
        self.model_cfg = model_cfg
        self.lora_cfg = lora_cfg
        self.page_elems = int(page_elems)
        self.elems = _sl.adapter_elems(model_cfg, lora_cfg)
        self.pages_per_adapter = -(-self.elems // self.page_elems)
        if num_pages <= 0:
            # Auto-size: room for 4 resident adapters.
            num_pages = 4 * self.pages_per_adapter
        if num_pages < self.pages_per_adapter:
            raise ValueError(
                f"adapter pool of {num_pages} pages cannot hold one "
                f"adapter ({self.pages_per_adapter} pages of "
                f"{self.page_elems} elems for {self.elems} elems)")
        self.num_pages = int(num_pages)
        self.max_batch_adapters = int(max_batch_adapters)
        self.int8 = bool(int8)
        self.device = resolve_device(device)
        self._loader = loader or _sl.default_adapter_loader(
            model_cfg, lora_cfg)
        # Scratch page = index num_pages: zeros, never written (upload
        # padding lands on real pages only).
        shape = (self.num_pages + 1, self.page_elems)
        if self.int8:
            self._device: Any = {
                "q": torch.zeros(shape, dtype=torch.int8, device=self.device),
                "scale": torch.ones((self.num_pages + 1, 1),
                                    dtype=torch.float32, device=self.device),
            }
        else:
            self._device = torch.zeros(shape, dtype=torch.float32,
                                       device=self.device)
        self._entries: Dict[str, str] = {}      # adapter_id -> content hash
        self._blocks: Dict[str, _Block] = {}    # content hash -> block
        self._free: List[int] = list(range(self.num_pages))
        self._clock = itertools.count(1)
        self._lock = threading.Lock()
        self.hits_total = 0
        self.misses_total = 0
        self.evictions_total = 0
        self._tm = _telemetry()
        self._tm["adapter_pool_pages"].set(self.num_pages)
        self._tm["adapter_resident"].set(0)

    # -- load / borrow -----------------------------------------------------

    def _load_flat(self, adapter_id: str) -> np.ndarray:
        flat = self._loader(adapter_id)
        if isinstance(flat, torch.Tensor) and flat.ndim == 1:
            flat = flat.detach().cpu().numpy()
        if not isinstance(flat, np.ndarray) or flat.ndim != 1:
            flat = _sl.flatten_adapter(flat, self.model_cfg, self.lora_cfg)
        flat = np.asarray(flat, np.float32)
        if flat.shape != (self.elems,):
            raise ValueError(
                f"adapter {adapter_id!r}: loader produced {flat.shape}, "
                f"want ({self.elems},)")
        return flat

    def _set_resident_gauge_locked(self) -> None:
        self._tm["adapter_resident"].set(
            len({i for b in self._blocks.values() for i in b.ids}))

    def _evict_one_locked(self) -> bool:
        victim_h, victim = None, None
        for h, block in self._blocks.items():
            if block.refs == 0 and (
                    victim is None or block.last_used < victim.last_used):
                victim_h, victim = h, block
        if victim is None:
            return False
        del self._blocks[victim_h]
        self._free.extend(victim.pages)
        self.evictions_total += 1
        self._tm["adapter_evictions"].inc()
        self._set_resident_gauge_locked()
        return True

    def _upload_locked(self, pages: List[int], flat: np.ndarray) -> None:
        pp, pe = self.pages_per_adapter, self.page_elems
        payload = np.zeros((pp, pe), np.float32)
        payload.reshape(-1)[:self.elems] = flat
        host = torch.from_numpy(payload)
        if self.device.type == "cuda":
            # Pinned and non-blocking: a pageable copy would wait for
            # every step already queued.
            host = host.pin_memory()
        dev = host.to(self.device, non_blocking=True)
        ids = torch.as_tensor(pages, dtype=torch.long).to(
            self.device, non_blocking=True)
        if self.int8:
            # Per-PAGE absmax: pages become the output-channel axis of
            # quantize_tensor by transposing the payload.
            qd = quantize_tensor(dev.T)
            self._device["q"][ids] = qd["q"].T
            self._device["scale"][ids] = qd["scale"].reshape(-1, 1)
        else:
            self._device[ids] = dev

    def acquire(self, adapter_id: str) -> None:
        """Pin ``adapter_id``'s pages (loading them if absent) for one
        in-flight row; the caller must ``release`` exactly once.  Raises
        AdapterPoolPressure when nothing is evictable (transient: retry
        once borrows drain)."""
        if not adapter_id:
            return  # null adapter: scratch page, nothing to pin
        with self._lock:
            h = self._entries.get(adapter_id)
            flat = None
            if h is None:
                flat = self._load_flat(adapter_id)
                h = hashlib.sha1(flat.tobytes()).hexdigest()
                self._entries[adapter_id] = h
            block = self._blocks.get(h)
            stamp = next(self._clock)
            if block is not None:
                block.refs += 1
                block.last_used = stamp
                block.ids.add(adapter_id)
                self.hits_total += 1
                self._tm["adapter_hits"].inc()
                self._set_resident_gauge_locked()
                return
            if flat is None:  # known hash, pages evicted: load again
                flat = self._load_flat(adapter_id)
            while len(self._free) < self.pages_per_adapter:
                if not self._evict_one_locked():
                    raise AdapterPoolPressure(
                        f"adapter pool: {adapter_id!r} needs "
                        f"{self.pages_per_adapter} pages, "
                        f"{len(self._free)} free and every resident "
                        f"adapter is borrowed")
            pages = [self._free.pop() for _ in range(self.pages_per_adapter)]
            self._upload_locked(pages, flat)
            block = _Block(pages)
            block.refs = 1
            block.last_used = stamp
            block.ids.add(adapter_id)
            self._blocks[h] = block
            self.misses_total += 1
            self._tm["adapter_misses"].inc()
            self._set_resident_gauge_locked()

    def release(self, adapter_id: str) -> None:
        """Unpin one borrow.  An unknown or unborrowed id is a double
        release: raise, never mask."""
        if not adapter_id:
            return
        with self._lock:
            h = self._entries.get(adapter_id)
            block = self._blocks.get(h) if h is not None else None
            if block is None or block.refs <= 0:
                raise RuntimeError(
                    f"adapter pool: release of {adapter_id!r} not "
                    f"borrowed (refcount underflow)")
            block.refs -= 1
            block.last_used = next(self._clock)

    def refcount(self, adapter_id: str) -> int:
        with self._lock:
            h = self._entries.get(adapter_id)
            block = self._blocks.get(h) if h is not None else None
            return -1 if block is None else block.refs

    # -- batch gather plan -------------------------------------------------

    @property
    def device_pool(self) -> Any:
        return self._device

    def page_table(self, batch_ids: Sequence[str]) -> np.ndarray:
        """[max_batch_adapters, pages_per_adapter] int32 gather plan: row
        0 and every unused row point at the scratch page (exact zeros);
        row 1 + j holds batch_ids[j]'s pages.  Every id must be resident
        (borrowed by the rows that use it)."""
        K, pp = self.max_batch_adapters, self.pages_per_adapter
        if len(batch_ids) > K - 1:
            raise ValueError(
                f"{len(batch_ids)} adapters in one batch, pool allows "
                f"{K - 1} (max_batch_adapters={K} incl. the null row)")
        table = np.full((K, pp), self.num_pages, np.int32)  # scratch
        with self._lock:
            for j, aid in enumerate(batch_ids):
                h = self._entries.get(aid)
                block = self._blocks.get(h) if h is not None else None
                if block is None:
                    raise RuntimeError(
                        f"adapter pool: {aid!r} not resident at "
                        f"page_table time (borrow-before-batch bug)")
                table[1 + j] = block.pages
        return table

    # -- read-side surfaces ------------------------------------------------

    def resident_ids(self) -> List[str]:
        with self._lock:
            out: Set[str] = set()
            for block in self._blocks.values():
                out |= block.ids
            return sorted(out)

    def summary(self) -> dict:
        """Compact view for adapter-affinity routing, as the prefix
        cache's ``summary()``."""
        return {"adapters": self.resident_ids()}

    def audit_snapshot(self) -> dict:
        """Consistent allocator view for the doctor plane (serve/audit):
        the free list, every resident block's pages / refs / ids, and the
        id → content-hash map, enough to recount the pool partition and
        borrow balance externally."""
        with self._lock:
            return {
                "num_pages": self.num_pages,
                "pages_per_adapter": self.pages_per_adapter,
                "free": list(self._free),
                "blocks": {h: {"pages": list(b.pages), "refs": b.refs,
                               "ids": sorted(b.ids)}
                           for h, b in self._blocks.items()},
                "entries": dict(self._entries),
            }

    def stats(self) -> dict:
        with self._lock:
            resident = sorted(
                {i for b in self._blocks.values() for i in b.ids})
            looked = self.hits_total + self.misses_total
            return {
                "pool_pages": self.num_pages,
                "pages_free": len(self._free),
                "pages_per_adapter": self.pages_per_adapter,
                "resident": len(resident),
                "resident_ids": resident,
                "hits": self.hits_total,
                "misses": self.misses_total,
                "evictions": self.evictions_total,
                "hit_ratio": (self.hits_total / looked) if looked else 0.0,
                "borrowed_refs": sum(b.refs for b in self._blocks.values()),
            }
