"""KV page-migration plane (a copy of ``ray_tpu/serve/kv_transfer.py``).

A finished prefix's KV pages move between engines' pools: a cold or
newly started engine ingests a warm one's hot prefixes instead of
recomputing them, and a prefill engine can hand a stream's pages to a
decode engine.  This module is the transfer plane those verbs ride on:

  * **Wire format**: `encode_pages`/`decode_payload` serialise gathered
    KV pages (k/v ``[L, KVH, N, page, D]`` plus per-page scales for int8
    pools, canonical ``[L, KVH, N]``) either exactly or through per-page
    int8 quantisation (absmax/127 scales, floored 1e-8).  The fields are
    the JAX package's, one for one, so a transfer made by either package
    decodes in the other.  Bytes on the wire are counted analytically
    (`page_transfer_wire_bytes`), so a host copy and a network report
    the same number.
  * **bf16 on the wire**: the JAX package ships an exact bf16 payload as
    a numpy ``bfloat16`` array.  numpy has no bfloat16 of its own, so the
    port ships bf16 pages widened exactly to float32 arrays, keeps
    ``src_dtype: "bfloat16"`` and counts ``wire_bytes`` at 2 bytes an
    element as the JAX package does.  A decoder narrows them back bit
    for bit; the port's decoder also takes a ``bfloat16``-named array
    when one arrives from the JAX package.
  * **Content identity**: every transfer carries the chained-CRC32 path
    hashes (`prefix_index.prefix_hashes`) of its token prefix; the
    destination recomputes them before touching its pool.
  * **Roles**: `DisaggContext` is the ambient per-replica role (set by
    whatever hosts the server); `MigrationHandoff` is the signal a
    prefill replica raises once its pages landed on a decode replica (a
    PreemptedError, so failover machinery carries it).

The engine-side verbs (lease, export, ingest, release) live on
`LLMEngine`: they run on the engine's loop thread, the only thread that
touches the pool.  Pages under a migration lease are eviction-proof
(`prefix_index` skips them), and every lease is released on every path.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.core.exceptions import PreemptedError
from ray_tpu_torch.serve.prefix_index import prefix_hashes

_TELEMETRY = None

# Bytes an element of each pool dtype takes on the wire (the name is the
# transfer's ``src_dtype``).
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def _telemetry():
    """Migration and disaggregation metric singletons, merged into the
    engine's telemetry dict (``llm_engine._telemetry``) so the families
    register at engine construction, before any page moves."""
    global _TELEMETRY
    from ray_tpu_torch.util import metrics

    if _TELEMETRY is None:
        _TELEMETRY = {
            "mig_pages": metrics.Counter(
                "raytpu_serve_kv_migration_pages_total",
                "KV pages moved between replica pools, by direction "
                "(out = exported under a migration lease, in = "
                "ingested into the local pool).",
                tag_keys=("direction",),
            ),
            "mig_bytes": metrics.Counter(
                "raytpu_serve_kv_migration_bytes_total",
                "Bytes-on-wire of KV page payloads (int8 page bytes + "
                "f32 per-page scales when quantized, raw dtype bytes "
                "when exact), by direction.  Analytic accounting "
                "(page_transfer_wire_bytes) so a host copy and a real "
                "network report the same number.",
                tag_keys=("direction",),
            ),
            "mig_seconds": metrics.Histogram(
                "raytpu_serve_kv_migration_seconds",
                "Wall time of one migration verb on the engine loop "
                "(export = lease gather + host pull + encode; ingest "
                "= decode + scatter + trie insert).",
                boundaries=[0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                            0.1, 0.25, 0.5, 1.0, 2.5, 5.0],
                tag_keys=("op",),
            ),
            "disagg_handoffs": metrics.Counter(
                "raytpu_serve_disagg_handoffs_total",
                "Prefill-to-decode stream handoffs by outcome "
                "(migrated = pages landed and the stream resumed on "
                "the decode replica; failed = transfer aborted and "
                "the continuation replay recomputed locally; local = "
                "no decode target, served unified).",
                tag_keys=("outcome",),
            ),
            "disagg_requests": metrics.Counter(
                "raytpu_serve_disagg_requests_total",
                "Streamed requests entering a disaggregated "
                "deployment, by the serving replica's role.",
                tag_keys=("role",),
            ),
        }
    else:
        reg = metrics.registry()
        for m in _TELEMETRY.values():
            reg.register(m)
    return _TELEMETRY


def page_transfer_wire_bytes(n_pages: int, elements_per_page: int, *,
                             quantized: bool, itemsize: int = 4,
                             scales_per_page: int = 1) -> int:
    """Bytes a KV page migration puts on the wire for one pool tensor
    (point to point, no peer multiplier; a copy of
    ``ray_tpu/parallel/collectives.page_transfer_wire_bytes``).  Quantized
    ships one int8 byte per element plus one f32 scale per (page, scale
    column); exact ships the storage bytes."""
    if n_pages <= 0:
        return 0
    if quantized:
        return n_pages * (elements_per_page * 1 + scales_per_page * 4)
    return n_pages * elements_per_page * itemsize


# -- ambient per-replica role -----------------------------------------------

@dataclasses.dataclass(frozen=True)
class DisaggContext:
    """The replica's disaggregation role plus what its server needs to
    run the handoff protocol."""

    role: str = "unified"  # "prefill" | "decode" | "unified"
    transfer: str = "int8"  # page payload wire format ("int8"|"exact")
    handoff_after_tokens: int = 1
    migration_timeout_s: float = 5.0
    app_name: str = ""
    deployment_name: str = ""
    replica_id: str = ""


_LOCAL = threading.local()


def set_disagg(ctx: Optional[DisaggContext]) -> None:
    _LOCAL.ctx = ctx


def current_disagg() -> Optional[DisaggContext]:
    """The installing replica's DisaggContext, or None outside a
    disaggregated deployment."""
    return getattr(_LOCAL, "ctx", None)


class MigrationHandoff(PreemptedError):
    """The prefill replica finished its share of the request AND its KV
    pages landed on ``target_replica_id``: the client should resume there
    (a prefix-cache hit covers everything migrated) instead of
    recomputing.  A PreemptedError, so failover treats it as retriable;
    if the target also fails, continuation replay recomputes locally."""

    def __init__(self, reason: str = "stream handed off",
                 continuation: Optional[dict] = None,
                 target_replica_id: str = ""):
        self.target_replica_id = target_replica_id
        super().__init__(reason, continuation)

    def __reduce__(self):
        return (type(self),
                (self.reason, self.continuation, self.target_replica_id))


# -- page payload codec -----------------------------------------------------

def _f32(x: Any) -> np.ndarray:
    """A payload array as float32: f32 and int8 as they are, a numpy
    ``bfloat16`` array from the JAX package widened exactly."""
    return np.asarray(x, np.float32)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A host array as a tensor sharing its memory (copied when the
    array is read-only, as a JAX array's host view is)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def quantize_page_payload(pages: np.ndarray):
    """``[L, KVH, N, page, D]`` float pages → (int8 pages, ``[L, KVH, N]``
    f32 per-page absmax scales): the host-side mirror of the int8 pool's
    write-side quantisation, scale = absmax/127 floored at 1e-8.  Pages
    are widened to f32 first, as in the JAX package, so both give the
    same bytes and scales."""
    p32 = _f32(pages)
    a = np.max(np.abs(p32), axis=(3, 4))
    scale = np.maximum(a / 127.0, 1e-8).astype(np.float32)
    q = np.clip(np.rint(p32 / scale[..., None, None]), -127, 127)
    return q.astype(np.int8), scale


def dequantize_page_payload(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Inverse of `quantize_page_payload`, in f32 (the caller narrows to
    its pool's dtype)."""
    return q.astype(np.float32) * np.asarray(scale)[..., None, None]


def encode_pages(gathered: Dict[str, np.ndarray], *,
                 tokens: Sequence[int], page_size: int,
                 mode: str = "int8",
                 src_dtype: Optional[str] = None) -> Dict[str, Any]:
    """Build one transfer dict from host-gathered pages.

    ``gathered``: "k"/"v" ``[L, KVH, N, page, D]``; int8 pools also carry
    "k_scale"/"v_scale" in the pool's page-major layout ``[L, N, KVH, 1]``
    (converted here to the canonical ``[L, KVH, N]``).  ``src_dtype``
    names the source pool's dtype ("bfloat16", "float32", "int8");
    None takes the arrays' own (a bf16 pool's pages arrive as exact f32,
    so its caller passes "bfloat16").  ``mode`` "exact" ships the
    storage values as they are (bf16 as exact f32); "int8" quantises
    float payloads per page (an int8 source is already quantised: no
    second quantisation)."""
    if mode not in ("int8", "exact"):
        raise ValueError(f"transfer mode must be 'int8' or 'exact', "
                         f"got {mode!r}")
    k, v = np.asarray(gathered["k"]), np.asarray(gathered["v"])
    L, KVH, N, page, D = k.shape
    if page != page_size or N * page_size != len(tokens):
        raise ValueError(
            f"payload shape {k.shape} does not cover {len(tokens)} "
            f"tokens at page_size={page_size}")
    src = src_dtype or str(k.dtype)
    if src not in _ITEMSIZE:
        raise ValueError(f"unsupported source pool dtype {src!r}")
    out: Dict[str, Any] = {
        "version": 1,
        "page_size": page_size,
        "tokens": [int(t) for t in tokens],
        "hashes": prefix_hashes(tokens, page_size),
        "src_dtype": src,
    }
    if "k_scale" in gathered:
        # int8 source pool: the payload is already quantised; reshape the
        # page-major scale columns [L, N, KVH, 1] → canonical [L, KVH, N].
        def canon(s):
            return np.ascontiguousarray(
                np.squeeze(np.asarray(s), -1).transpose(0, 2, 1)
            ).astype(np.float32)

        out.update(mode="int8", k=k.astype(np.int8), v=v.astype(np.int8),
                   k_scale=canon(gathered["k_scale"]),
                   v_scale=canon(gathered["v_scale"]))
    elif mode == "int8":
        qk, sk = quantize_page_payload(k)
        qv, sv = quantize_page_payload(v)
        out.update(mode="int8", k=qk, v=qv, k_scale=sk, v_scale=sv)
    else:
        # Exact: f32 carries every bf16 (and f32) value exactly.
        out.update(mode="exact", k=_f32(k), v=_f32(v))
    elements = L * KVH * page * D
    out["wire_bytes"] = 2 * page_transfer_wire_bytes(
        N, elements, quantized=out["mode"] == "int8",
        itemsize=_ITEMSIZE[src], scales_per_page=L * KVH)
    return out


def decode_payload(transfer: Dict[str, Any], pool_quantized: bool,
                   pool_dtype: torch.dtype = torch.float32,
                   start_page: int = 0,
                   end_page: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """Transfer dict → host tensors in the DESTINATION pool's storage
    layout and dtype, sliced to pages ``[start_page, end_page)`` (the
    destination skips depths it already caches).  Every source ×
    destination combination: exact float payloads narrow to the pool's
    dtype, int8 payloads dequantise into float pools, float payloads
    quantise into int8 pools, and int8 → int8 ships raw bytes and scales
    with no requantisation."""
    sl = slice(start_page, end_page)
    k = np.asarray(transfer["k"])[:, :, sl]
    v = np.asarray(transfer["v"])[:, :, sl]
    quant_payload = transfer["mode"] == "int8"
    if quant_payload:
        ks = _f32(transfer["k_scale"])[:, :, sl]
        vs = _f32(transfer["v_scale"])[:, :, sl]
    if pool_quantized:
        if not quant_payload:
            k, ks = quantize_page_payload(k)
            v, vs = quantize_page_payload(v)

        # canonical [L, KVH, n] scales → pool page-major [L, n, KVH, 1]
        def pool_scale(s):
            return _tensor(s.transpose(0, 2, 1)[..., None].astype(np.float32))

        return {"k": _tensor(k.astype(np.int8, copy=False)),
                "v": _tensor(v.astype(np.int8, copy=False)),
                "k_scale": pool_scale(ks), "v_scale": pool_scale(vs)}
    if quant_payload:
        k, v = dequantize_page_payload(k, ks), dequantize_page_payload(v, vs)

    def narrow(x):
        return _tensor(_f32(x)).to(pool_dtype)

    return {"k": narrow(k), "v": narrow(v)}


def transfer_num_pages(transfer: Dict[str, Any]) -> int:
    return int(np.asarray(transfer["k"]).shape[2])


def verify_transfer(transfer: Dict[str, Any]) -> List[int]:
    """Recompute the chained-CRC32 path hashes over the transfer's tokens
    and check them against the sender's: content identity is established
    BEFORE any page touches the local pool.  Returns the verified hash
    chain."""
    page = int(transfer["page_size"])
    tokens = transfer["tokens"]
    expect = prefix_hashes(tokens, page)
    got = [int(h) for h in transfer["hashes"]]
    if got != expect:
        raise ValueError(
            f"kv transfer content-identity mismatch: sender hashes "
            f"{got[:4]}... != recomputed {expect[:4]}... "
            f"({len(tokens)} tokens, page={page})")
    n = transfer_num_pages(transfer)
    if n != len(tokens) // page or n != len(expect):
        raise ValueError(
            f"kv transfer page count {n} does not match "
            f"{len(tokens)} tokens at page={page}")
    return expect
