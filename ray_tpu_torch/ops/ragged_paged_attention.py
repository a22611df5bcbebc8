"""Ragged paged attention: one batch of mixed prefill chunks and decode
rows (port of ``ray_tpu/ops/ragged_paged_attention.py``, bf16/f32 and
int8 pools).

A ragged step packs R rows into one flat token buffer of T tokens:

    tokens   [T]             decode rows carry one token, prefill rows a
                             chunk of their prompt
    rows     (slot, start, len, off) x R
                             start = tokens of the slot already in the
                             pool, len = fresh tokens this step (0 =
                             padding row), off = the row's offset in the
                             buffer; rows occupy distinct slots

Per layer, every packed token attends to its slot's pooled past plus the
causal prefix of its own row's fresh tokens (K4,
``ragged_paged_attention``); the pools stay read-only inside the layer
loop, and ONE in-place append after it writes every layer's fresh k/v
into the pages (K5, ``ragged_paged_append``; on int8 pools K6,
``ragged_paged_append_quantized``, which also keeps the grow-only scale
of every page it touches).  int8 pools carry ``k_scales``/``v_scales``
[L, P, KVH, 1] f32, page-major.

With ``LlamaConfig.fused_decode`` the whole decoder layer runs as one
call over the ragged batch (K8, ``fused_ragged_layer``: K7's layer with
ragged attention in the middle); its fresh rows go through the same
append.

Each kernel is a CUDA kernel for Hopper (``csrc/ragged_attention.cu``,
``csrc/ragged_append.cu``, ``csrc/ragged_append_quantized.cu``,
``csrc/fused_ragged.cu``) with its plain PyTorch version beside it.  A wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``pack_ragged_batch`` is the host-side packer (numpy), a copy of
the JAX package's.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.fused_decode import (
    launch_fused_layer,
    layer_mlp_reference,
    layer_qkv_reference,
)
from ray_tpu_torch.ops.paged_attention import (
    _DTYPE_CODE,
    _SMEM_LIMIT,
    NEG_INF,
    _check_cuda,
    _check_scales,
    _quant_round,
    _stream_ptr,
)

# K4's CUDA instantiations: head dims it takes, and its tile shape (a
# q tile of 64 query rows = tokens x heads of one kv head, keys staged
# 64 at a time).
_K4_HEAD_DIMS = (16, 32, 64, 128)
_K4_ROWS = 64
_K4_KEYS = 64
# K5: tokens of one row per CTA.
_K5_TOKENS = 16
# The Hopper attention of K4 and K8 (csrc/ragged_attention.cuh): q tiles
# of 64 query rows, keys in blocks of 64, a cluster of up to 8 CTAs
# splitting a tile's blocks; the wrapper sizes the cluster so that a rank
# walks at most this many blocks of the longest tile.
_HOPPER_ROWS = 64
_HOPPER_KEYS = 64
HOPPER_BLOCKS_PER_RANK = 24


def _round8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def window_size(T: int, max_row_tokens: Optional[int]) -> int:
    """The JAX kernel's static q-window width (TPU sublane alignment).
    The CUDA kernels index each row's own tokens and need no window;
    this copy keeps ``max_row_tokens`` meaning the same in both
    packages."""
    cap = T if max_row_tokens is None else min(max_row_tokens, T)
    return min(_round8(T), _round8(cap) + 8)


def pages_per_row(max_row_tokens: int, page: int) -> int:
    """Static bound on the pages one row's fresh tokens can touch."""
    return (max_row_tokens + page - 2) // page + 1


# --------------------------------------------------------------------------
# host-side packing
# --------------------------------------------------------------------------

def pack_ragged_batch(rows, token_budget: int, max_slots: int,
                      with_adapters: bool = False):
    """Host-side packer: ``rows`` is a list of dicts with keys ``slot``,
    ``start``, ``tokens`` (list[int] for prefill chunks, or None for
    decode rows whose token lives on the device).  Returns numpy arrays
    sized (token_budget, max_slots):

        host_toks, decode_mask, tok_slot, tok_pos  [T]
        row_slot, row_start, row_len, row_off      [R]

    With ``with_adapters`` a ninth array ``tok_adapter`` [T] follows:
    each row's optional ``adapter`` key (an index into the step's adapter
    gather set, ops/segmented_lora) over its tokens, 0 (the null adapter)
    for rows without one and for padding.  Padding rows get len 0 / slot
    0; padding tokens get pos 0.  Packing past the budget or the slot
    count is a scheduler bug and asserts."""
    T, R = token_budget, max_slots
    host_toks = np.zeros(T, np.int32)
    decode_mask = np.zeros(T, bool)
    tok_slot = np.zeros(T, np.int32)
    tok_pos = np.zeros(T, np.int32)
    tok_adapter = np.zeros(T, np.int32)
    row_slot = np.zeros(R, np.int32)
    row_start = np.zeros(R, np.int32)
    row_len = np.zeros(R, np.int32)
    row_off = np.zeros(R, np.int32)
    cursor = 0
    for i, row in enumerate(rows):
        toks = row.get("tokens")
        n = 1 if toks is None else len(toks)
        assert cursor + n <= T and i < R, "packer overflow"
        row_slot[i] = row["slot"]
        row_start[i] = row["start"]
        row_len[i] = n
        row_off[i] = cursor
        tok_slot[cursor:cursor + n] = row["slot"]
        tok_pos[cursor:cursor + n] = row["start"] + np.arange(n)
        tok_adapter[cursor:cursor + n] = row.get("adapter", 0)
        if toks is None:
            decode_mask[cursor] = True
        else:
            host_toks[cursor:cursor + n] = np.asarray(toks, np.int32)
        cursor += n
    out = (host_toks, decode_mask, tok_slot, tok_pos,
           row_slot, row_start, row_len, row_off)
    return out + (tok_adapter,) if with_adapters else out


# --------------------------------------------------------------------------
# references (test oracles, one layer)
# --------------------------------------------------------------------------

def _row_masks(T: int, off, nt, device):
    ti = torch.arange(T, device=device)
    trel = ti - off
    return trel, (trel >= 0) & (trel < nt)


def ragged_attention_reference(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
    k_pages: torch.Tensor, v_pages: torch.Tensor,
    row_slot: torch.Tensor, row_start: torch.Tensor, row_len: torch.Tensor,
    row_off: torch.Tensor, block_tables: torch.Tensor, *,
    soft_cap: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense gather reference for ONE layer's pages [KVH, P, page, D]:
    for each row, attention of its fresh tokens over (pooled past) +
    (intra-row causal fresh), f32 out [T, H, D].  Buffer tokens no row
    covers come back zero.  int8 pages take that layer's scales
    [P, KVH, 1] and are dequantised first; the fresh k/v never carry a
    scale.  Loops over the R rows (a shape, no host sync)."""
    T, H, D = q.shape
    KVH, P, page, _ = k_pages.shape
    maxp = block_tables.shape[1]
    group = H // KVH
    ctx = maxp * page
    dev = q.device
    out = torch.zeros((T, H, D), dtype=torch.float32, device=dev)
    qs = q.float()
    knf = k_new.float().repeat_interleave(group, dim=1)     # [T, H, D]
    vnf = v_new.float().repeat_interleave(group, dim=1)
    s_self = torch.einsum("thd,uhd->thu", qs, knf) * (D ** -0.5)
    if soft_cap is not None:
        s_self = soft_cap * torch.tanh(s_self / soft_cap)
    kpos = torch.arange(ctx, device=dev)
    bt = block_tables.long().clamp(0, P - 1)
    kf, vf = k_pages.float(), v_pages.float()
    if k_scales is not None:
        kf = kf * k_scales.permute(1, 0, 2)[:, :, None, :]
        vf = vf * v_scales.permute(1, 0, 2)[:, :, None, :]
    for r in range(row_slot.shape[0]):
        slot, start = row_slot[r].long(), row_start[r]
        trel, in_row = _row_masks(T, row_off[r], row_len[r], dev)
        pages = bt[slot]                                   # [maxp]
        kc = kf[:, pages].permute(1, 2, 0, 3).reshape(ctx, KVH, D)
        vc = vf[:, pages].permute(1, 2, 0, 3).reshape(ctx, KVH, D)
        kx = kc.repeat_interleave(group, dim=1)            # [ctx, H, D]
        vx = vc.repeat_interleave(group, dim=1)
        s_pool = torch.einsum("thd,khd->thk", qs, kx) * (D ** -0.5)
        if soft_cap is not None:
            s_pool = soft_cap * torch.tanh(s_pool / soft_cap)
        m_pool = in_row[:, None, None] & (kpos < start)[None, None, :]
        m_self = (in_row[:, None, None] & in_row[None, None, :]
                  & (trel[None, None, :] <= trel[:, None, None]))
        s = torch.cat([torch.where(m_pool, s_pool, NEG_INF),
                       torch.where(m_self, s_self, NEG_INF)], dim=-1)
        p = torch.softmax(s, dim=-1)
        o = (torch.einsum("thk,khd->thd", p[..., :ctx], vx)
             + torch.einsum("thu,uhd->thd", p[..., ctx:], vnf))
        out = torch.where(in_row[:, None, None], o, out)
    return out


def ragged_append_reference(k_pages, v_pages, k_new, v_new, row_slot,
                            row_start, row_len, row_off, block_tables):
    """Scatter reference for the append, ONE layer (pages [KVH, P, page,
    D], new [T, KVH, D]); returns new pages, the inputs untouched.
    Tokens outside every row write the scratch page P - 1 with its own
    contents."""
    k_pages, v_pages = k_pages.clone(), v_pages.clone()
    T = k_new.shape[0]
    KVH, P, page, D = k_pages.shape
    maxp = block_tables.shape[1]
    bt = block_tables.long().clamp(0, P - 1)
    for r in range(row_slot.shape[0]):
        trel, in_row = _row_masks(T, row_off[r], row_len[r], k_new.device)
        pos = row_start[r] + trel
        pid = bt[row_slot[r].long()][(pos // page).clamp(0, maxp - 1)]
        pid = torch.where(in_row, pid, P - 1)
        offp = torch.where(in_row, pos % page, 0)
        for pages, new in ((k_pages, k_new), (v_pages, v_new)):
            cur = pages[:, pid, offp]
            pages[:, pid, offp] = torch.where(
                in_row[None, :, None],
                new.permute(1, 0, 2).to(pages.dtype), cur)
    return k_pages, v_pages


# --------------------------------------------------------------------------
# K4: ragged paged attention, one layer
# --------------------------------------------------------------------------

def hopper_attention_plan(T: int, R: int, qpg: int, maxp: int,
                          page: int) -> Tuple[int, int]:
    """(cluster size, q-tile slots) of the Hopper attention for a call
    of T tokens in R rows, from static bounds only (the row lengths stay
    on the card): the slots bound every row's tiles, sum of ceil(len *
    qpg / 64) <= ceil(T * qpg / 64) + R; the cluster is the smallest
    power of two, at most 8, that leaves a rank at most
    ``HOPPER_BLOCKS_PER_RANK`` key blocks of the longest tile (its pooled
    past of up to maxp pages, then its fresh keys)."""
    slots = max(1, -(-T * qpg // _HOPPER_ROWS) + R)
    blocks = -(-maxp * page // _HOPPER_KEYS) + -(-T // _HOPPER_KEYS)
    cluster = 1
    while cluster < 8 and -(-blocks // cluster) > HOPPER_BLOCKS_PER_RANK:
        cluster *= 2
    return cluster, slots


def _hopper_attention_ok(D: int, page: int, qpg: int, R: int, *tensors
                         ) -> bool:
    """Whether the Hopper kernel takes these shapes (bf16 is the
    caller's check): D 64 or 128, TMA boxes of whole 8-row groups that
    tile 64 keys, whole query heads in a 64-row tile, 16-byte aligned
    operands, and the rows' tile counts fit its scratch."""
    return (D in (64, 128) and page % 8 == 0
            and (page % _HOPPER_KEYS == 0 or _HOPPER_KEYS % page == 0)
            and _HOPPER_ROWS % qpg == 0 and R * 4 <= 4 * 64 * D * 2
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                    for t in tensors))


def ragged_paged_attention_plain(
    q, k_new, v_new, k_pools, v_pools, layer: int, row_slot, row_start,
    row_len, row_off, block_tables, *, soft_cap: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of K4: the dense gather reference on layer
    ``layer`` of the pools [L, KVH, P, page, D] (and of the scales
    [L, P, KVH, 1] of int8 pools)."""
    scales = {}
    if k_scales is not None:
        scales = {"k_scales": k_scales[layer], "v_scales": v_scales[layer]}
    return ragged_attention_reference(
        q, k_new, v_new, k_pools[layer], v_pools[layer], row_slot,
        row_start, row_len, row_off, block_tables, soft_cap=soft_cap,
        **scales)


def ragged_paged_attention(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
    k_pools: torch.Tensor, v_pools: torch.Tensor, layer: int,
    row_slot: torch.Tensor, row_start: torch.Tensor, row_len: torch.Tensor,
    row_off: torch.Tensor, block_tables: torch.Tensor, *,
    soft_cap: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    max_row_tokens: Optional[int] = None,
) -> torch.Tensor:
    """Causal attention of a ragged token batch against layer ``layer``
    (a Python int) of the pools: q [T, H, D], k_new/v_new [T, KVH, D],
    pools [L, KVH, P, page, D] (P includes the scratch page), rows [R]
    int32, block_tables [slots, maxp] int32 → f32 [T, H, D], exact zeros
    on tokens no row covers.  Pools are read-only; append the fresh k/v
    afterwards with ``ragged_paged_append``.  Rows must occupy distinct
    slots.  ``max_row_tokens`` bounds the JAX kernel's VMEM window; the
    CUDA kernel needs none and ignores it.

    int8 pools: pass ``k_scales``/``v_scales`` [L, P, KVH, 1] f32; q and
    the fresh k/v stay f32 or bf16 and carry no scale.

    CUDA tensors launch kernel K4 (csrc/ragged_attention.cu: in bf16 at
    D 64 and 128 the Hopper kernel of csrc/ragged_attention.cuh, planned
    by ``hopper_attention_plan``; its int8 instantiation when scales are
    given, counted in ``launches_int8`` too); CPU tensors run the plain
    version."""
    quantized = _check_scales("ragged_paged_attention", k_pools, v_pools,
                              k_scales, v_scales)
    if not q.is_cuda:
        return ragged_paged_attention_plain(
            q, k_new, v_new, k_pools, v_pools, layer, row_slot, row_start,
            row_len, row_off, block_tables, soft_cap=soft_cap,
            k_scales=k_scales, v_scales=v_scales)
    T, H, D = q.shape
    L, KVH, P, page, Dk = k_pools.shape
    R = row_slot.shape[0]
    maxp = block_tables.shape[1]
    _check_cuda("ragged_paged_attention", q=q, k_new=k_new, v_new=v_new,
                k_pools=k_pools, v_pools=v_pools, row_slot=row_slot,
                row_start=row_start, row_len=row_len, row_off=row_off,
                block_tables=block_tables)
    if quantized:
        _check_cuda("ragged_paged_attention", k_scales=k_scales,
                    v_scales=v_scales)
    dt = q.dtype
    pool_dt = torch.int8 if quantized else dt
    if dt not in _DTYPE_CODE or any(
            t.dtype != dt for t in (k_new, v_new)) or any(
            t.dtype != pool_dt for t in (k_pools, v_pools)):
        raise ValueError("ragged_paged_attention: q, k_new and v_new must "
                         "share dtype f32 or bf16 and the pools be of that "
                         "dtype (int8 with scales), got "
                         f"{[t.dtype for t in (q, k_new, v_new, k_pools)]}")
    if any(t.dtype != torch.int32 for t in (row_slot, row_start, row_len,
                                            row_off, block_tables)):
        raise ValueError("ragged_paged_attention: rows and block_tables must "
                         "be int32")
    if (v_pools.shape != k_pools.shape or Dk != D or H % KVH
            or k_new.shape != (T, KVH, D) or v_new.shape != k_new.shape
            or any(t.shape != (R,) for t in (row_start, row_len, row_off))):
        raise ValueError(
            f"ragged_paged_attention: bad shapes q {tuple(q.shape)}, k_new "
            f"{tuple(k_new.shape)}, pools {tuple(k_pools.shape)}, rows "
            f"{[tuple(t.shape) for t in (row_start, row_len, row_off)]}")
    qpg = H // KVH
    if D not in _K4_HEAD_DIMS or qpg > _K4_ROWS or not 0 <= layer < L:
        raise ValueError(f"ragged_paged_attention: unsupported D={D} (want "
                         f"one of {_K4_HEAD_DIMS}), qpg={qpg} (max "
                         f"{_K4_ROWS}) or layer={layer}")
    smem = 4 * (_K4_ROWS * (D + 4) + _K4_KEYS * (2 * D + 4)
                + _K4_ROWS * (_K4_KEYS + 4) + 2 * _K4_KEYS)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ragged_paged_attention: D={D} needs {smem} B of "
                         "shared memory, over the H100's 227 KB")
    out = torch.zeros((T, H, D), dtype=torch.float32, device=q.device)
    if T == 0 or R == 0:
        return out
    if dt == torch.bfloat16 and _hopper_attention_ok(
            D, page, qpg, R, q, k_new, v_new, k_pools, v_pools):
        cluster, n_tiles = hopper_attention_plan(T, R, qpg, maxp, page)
    else:
        # The CUDA-core kernel: one CTA per (row, kv head, q tile of
        # 64 // qpg tokens); tiles past a row's length exit at once.
        cluster, n_tiles = 0, -(-T // (_K4_ROWS // qpg))
    lib = _build.library("ragged_attention")
    fn = lib.rtt_ragged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
             k_pools.data_ptr(), v_pools.data_ptr(),
             k_scales.data_ptr() if quantized else None,
             v_scales.data_ptr() if quantized else None,
             row_slot.data_ptr(),
             row_start.data_ptr(), row_len.data_ptr(), row_off.data_ptr(),
             block_tables.data_ptr(), out.data_ptr(), _DTYPE_CODE[dt], H,
             KVH, P, page, D, maxp, R, n_tiles, int(layer), D ** -0.5,
             float(soft_cap) if soft_cap is not None else 0.0, L, T,
             cluster, _stream_ptr(q))
    _build.check(err, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    if quantized:
        ragged_paged_attention.launches_int8 += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.launches_int8 = 0


# --------------------------------------------------------------------------
# K5: ragged append, all layers, in place
# --------------------------------------------------------------------------

def ragged_paged_append_plain(k_pools, v_pools, k_new, v_new, row_slot,
                              row_start, row_len, row_off,
                              block_tables) -> None:
    """Plain version of K5, in place: each token's (page, offset) from
    its row, one index assignment per pool.  Tokens no row covers write
    the scratch page P - 1 (garbage-tolerant), never a live page."""
    L, KVH, P, page, D = k_pools.shape
    T = k_new.shape[1]
    maxp = block_tables.shape[1]
    dev = k_new.device
    ti = torch.arange(T, device=dev)
    off = row_off.long()[:, None]
    in_row = ((ti[None, :] >= off)
              & (ti[None, :] < off + row_len.long()[:, None]))
    covered = in_row.any(dim=0)
    r = in_row.int().argmax(dim=0)                      # row of each token
    pos = row_start.long()[r] + ti - row_off.long()[r]
    bt = block_tables.long().clamp(0, P - 1)
    pid = bt[row_slot.long()[r], (pos // page).clamp(0, maxp - 1)]
    pid = torch.where(covered, pid, P - 1)
    offp = torch.where(covered, pos % page, 0)
    k_pools[:, :, pid, offp] = k_new.permute(0, 2, 1, 3).to(k_pools.dtype)
    v_pools[:, :, pid, offp] = v_new.permute(0, 2, 1, 3).to(v_pools.dtype)


def ragged_paged_append(k_pools: torch.Tensor, v_pools: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        row_slot: torch.Tensor, row_start: torch.Tensor,
                        row_len: torch.Tensor, row_off: torch.Tensor,
                        block_tables: torch.Tensor, *,
                        max_row_tokens: Optional[int] = None) -> None:
    """Append every row's fresh tokens into its pages, for EVERY layer
    at once, IN PLACE: pools [L, KVH, P, page, D], k_new/v_new
    [L, T, KVH, D], rows [R] and block_tables [slots, maxp] int32.
    Token t of row r lands at position start + t of its slot.  Tokens no
    row covers write nothing.  The caller owns the pools and sees them
    mutated; nothing is returned.  ``max_row_tokens`` is accepted for
    the JAX signature and ignored.

    CUDA tensors launch kernel K5 (csrc/ragged_append.cu); CPU tensors
    run the plain version."""
    if not k_pools.is_cuda:
        ragged_paged_append_plain(k_pools, v_pools, k_new, v_new, row_slot,
                                  row_start, row_len, row_off, block_tables)
        return
    L, KVH, P, page, D = k_pools.shape
    T = k_new.shape[1]
    R = row_slot.shape[0]
    maxp = block_tables.shape[1]
    _check_cuda("ragged_paged_append", k_pools=k_pools, v_pools=v_pools,
                k_new=k_new, v_new=v_new, row_slot=row_slot,
                row_start=row_start, row_len=row_len, row_off=row_off,
                block_tables=block_tables)
    dt = k_pools.dtype
    if dt not in _DTYPE_CODE or any(t.dtype != dt
                                    for t in (v_pools, k_new, v_new)):
        raise ValueError("ragged_paged_append: pools and new rows must share "
                         f"dtype f32 or bf16, got {dt}, {v_pools.dtype}, "
                         f"{k_new.dtype}, {v_new.dtype}")
    if any(t.dtype != torch.int32 for t in (row_slot, row_start, row_len,
                                            row_off, block_tables)):
        raise ValueError("ragged_paged_append: rows and block_tables must "
                         "be int32")
    if (v_pools.shape != k_pools.shape or k_new.shape != (L, T, KVH, D)
            or v_new.shape != k_new.shape
            or any(t.shape != (R,) for t in (row_start, row_len, row_off))):
        raise ValueError(
            f"ragged_paged_append: bad shapes pools {tuple(k_pools.shape)}, "
            f"new {tuple(k_new.shape)}, rows {tuple(row_slot.shape)}")
    row_bytes = D * k_pools.element_size()
    if row_bytes % 16:
        raise ValueError(f"ragged_paged_append: a row of {row_bytes} B is "
                         "not a multiple of 16")
    if T == 0 or R == 0:
        return
    lib = _build.library("ragged_append")
    fn = lib.rtt_ragged_append
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    err = fn(k_pools.data_ptr(), v_pools.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), row_slot.data_ptr(), row_start.data_ptr(),
             row_len.data_ptr(), row_off.data_ptr(), block_tables.data_ptr(),
             L, T, R, KVH, P, page, maxp, row_bytes, -(-T // _K5_TOKENS),
             _stream_ptr(k_pools))
    _build.check(err, "ragged_paged_append")
    ragged_paged_append.launches += 1


ragged_paged_append.launches = 0


# --------------------------------------------------------------------------
# K6: ragged append into int8 pools, all layers, in place
# --------------------------------------------------------------------------

def _per_page(x: torch.Tensor) -> torch.Tensor:
    """[L, R, KVH] page scalars -> [L, KVH, R, 1, 1] beside the pages."""
    return x.permute(0, 2, 1)[..., None, None]


def ragged_paged_append_quantized_plain(k_pools, v_pools, k_scales, v_scales,
                                        k_new, v_new, row_slot, row_start,
                                        row_len, row_off,
                                        block_tables) -> None:
    """Plain version of K6, in place.  Per (row, layer, page the row's
    fresh tokens touch, kv head), for k and v alike: a page the row
    writes from its offset 0 is fresh (stale bytes zeroed, scale = the
    landing tokens' absmax / 127, floored at 1e-8); a page extended past
    existing tokens keeps its bytes unless the scale must grow, and then
    requantises them by old / new.  Tokens are quantised by dividing by
    the scale.  Pages no token of a row touches, and tokens no row
    covers, write nothing.  Walks each row's j-th touched page for j
    below the static bound ``pages_per_row(T, page)``; the live (row, j)
    pairs are picked by a boolean index (a host sync on a CUDA tensor)."""
    L, KVH, P, page, D = k_pools.shape
    T = k_new.shape[1]
    maxp = block_tables.shape[1]
    dev = k_new.device
    start, nt, off = row_start.long(), row_len.long(), row_off.long()
    bt = block_tables.long().clamp(0, P - 1)
    cells = torch.arange(page, device=dev)
    for j in range(pages_per_row(T, page)):
        pg = start // page + j
        base = pg * page
        live = ((base < start + nt) & (nt > 0)).nonzero()[:, 0]
        if live.numel() == 0:
            break
        tpage = base[live, None] + cells[None, :] - start[live, None]
        wrote = (tpage >= 0) & (tpage < nt[live, None])          # [Rl, page]
        src = (off[live, None] + tpage).clamp(0, T - 1)
        pid = bt[row_slot.long()[live], pg[live].clamp(0, maxp - 1)]
        fresh = (base >= start)[live][None, :, None]              # [1, Rl, 1]
        w5 = wrote[None, None, :, :, None]            # [1, 1, Rl, page, 1]
        for pools, scales, new in ((k_pools, k_scales, k_new),
                                   (v_pools, v_scales, v_new)):
            # [L, Rl, page, KVH, D] -> [L, KVH, Rl, page, D]
            landing = new[:, src].float().permute(0, 3, 1, 2, 4)
            amax = torch.where(w5, landing.abs(), 0.0).amax(dim=(3, 4))
            needed = (amax / torch.full_like(amax, 127.0)).clamp(
                min=1e-8).permute(0, 2, 1)
            s_old = scales[:, pid, :, 0]                          # [L, Rl, KVH]
            s_new = torch.where(fresh, needed, torch.maximum(s_old, needed))
            factor = torch.where(
                fresh, torch.zeros_like(s_old),
                torch.where(s_new > s_old, s_old / s_new,
                            torch.ones_like(s_old)))
            cur = pools[:, :, pid].float()
            out = torch.where(w5, _quant_round(landing / _per_page(s_new)),
                              torch.round(cur * _per_page(factor)))
            pools[:, :, pid] = out.clamp(-127, 127).to(torch.int8)
            scales[:, pid, :, 0] = s_new


def ragged_paged_append_quantized(
        k_pools: torch.Tensor, v_pools: torch.Tensor,
        k_scales: torch.Tensor, v_scales: torch.Tensor,
        k_new: torch.Tensor, v_new: torch.Tensor, row_slot: torch.Tensor,
        row_start: torch.Tensor, row_len: torch.Tensor,
        row_off: torch.Tensor, block_tables: torch.Tensor, *,
        max_row_tokens: Optional[int] = None) -> None:
    """Append every row's fresh tokens into its int8 pages, for EVERY
    layer at once, IN PLACE on pools and scales: pools int8
    [L, KVH, P, page, D], scales f32 [L, P, KVH, 1], k_new/v_new
    [L, T, KVH, D] f32 or bf16, rows [R] and block_tables [slots, maxp]
    int32.  Rows occupy distinct slots, so no two rows share a live
    page; a page a row does not touch (a borrowed prefix page before its
    start) keeps bytes and scale.  ``max_row_tokens`` is accepted for
    the JAX signature and ignored.  Nothing is returned.

    CUDA tensors launch kernel K6 (csrc/ragged_append_quantized.cu: one
    warp a (layer, row, page, kv head, k or v) page the rows' tokens touch,
    found on the card without a host sync); CPU tensors run the plain
    version."""
    _check_scales("ragged_paged_append_quantized", k_pools, v_pools,
                  k_scales, v_scales)
    if not k_pools.is_cuda:
        ragged_paged_append_quantized_plain(
            k_pools, v_pools, k_scales, v_scales, k_new, v_new, row_slot,
            row_start, row_len, row_off, block_tables)
        return
    L, KVH, P, page, D = k_pools.shape
    T = k_new.shape[1]
    R = row_slot.shape[0]
    maxp = block_tables.shape[1]
    _check_cuda("ragged_paged_append_quantized", k_pools=k_pools,
                v_pools=v_pools, k_scales=k_scales, v_scales=v_scales,
                k_new=k_new, v_new=v_new, row_slot=row_slot,
                row_start=row_start, row_len=row_len, row_off=row_off,
                block_tables=block_tables)
    if k_new.dtype not in _DTYPE_CODE or v_new.dtype != k_new.dtype:
        raise ValueError("ragged_paged_append_quantized: new rows must share "
                         f"dtype f32 or bf16, got {k_new.dtype}, "
                         f"{v_new.dtype}")
    if any(t.dtype != torch.int32 for t in (row_slot, row_start, row_len,
                                            row_off, block_tables)):
        raise ValueError("ragged_paged_append_quantized: rows and "
                         "block_tables must be int32")
    if (v_pools.shape != k_pools.shape or k_new.shape != (L, T, KVH, D)
            or v_new.shape != k_new.shape
            or any(t.shape != (R,) for t in (row_start, row_len, row_off))):
        raise ValueError(
            f"ragged_paged_append_quantized: bad shapes pools "
            f"{tuple(k_pools.shape)}, new {tuple(k_new.shape)}, rows "
            f"{tuple(row_slot.shape)}")
    if D % 16:
        raise ValueError(f"ragged_paged_append_quantized: an int8 row of "
                         f"{D} B is not a multiple of 16")
    if T == 0 or R == 0:
        return
    # The grid's bound on the live (row, page) pairs (a row of n tokens
    # touches at most n / page + 2 pages), and the landing tokens a warp
    # keeps in shared memory (32 bf16 rows of head_dim 128: seven CTAs an
    # SM; the rest of a fuller page is read again in the last pass).
    pairs = 2 * R + -(-T // page)
    cap = min(page, _K6_SMEM // (_K6_WARPS * D * k_new.element_size()))
    lib = _build.library("ragged_append_quantized")
    fn = lib.rtt_ragged_append_quantized
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p]
    err = fn(k_pools.data_ptr(), v_pools.data_ptr(), k_scales.data_ptr(),
             v_scales.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
             row_slot.data_ptr(), row_start.data_ptr(), row_len.data_ptr(),
             row_off.data_ptr(), block_tables.data_ptr(),
             _DTYPE_CODE[k_new.dtype], L, T, R, KVH, P, page, D, maxp,
             pairs, cap, _stream_ptr(k_pools))
    _build.check(err, "ragged_paged_append_quantized")
    ragged_paged_append_quantized.launches += 1


ragged_paged_append_quantized.launches = 0


# K6's warps a CTA (csrc: WARPS) and the shared memory a CTA keeps
# landing rows in.
_K6_WARPS = 4
_K6_SMEM = 32 * 1024


# --------------------------------------------------------------------------
# K8: one fused decoder layer over the ragged batch
# --------------------------------------------------------------------------

# K8's attention phase (csrc/fused_ragged.cu): query rows (tokens x the
# heads of one kv group) per CTA, keys per block, and the head dims it is
# instantiated for.
_K8_QROWS = 32
_K8_KEYS = 64
_K8_HEAD_DIMS = (16, 32, 64, 128)


def fused_ragged_layer_reference(
    x: torch.Tensor, layer, k_pools: torch.Tensor, v_pools: torch.Tensor,
    layer_idx: int, row_slot: torch.Tensor, row_start: torch.Tensor,
    row_len: torch.Tensor, row_off: torch.Tensor,
    block_tables: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, *,
    eps: float, n_heads: int, n_kv_heads: int,
    soft_cap: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    max_row_tokens: Optional[int] = None,
):
    """Plain version of K8: K7's layer phases around ragged attention in
    f32 (q unrounded, pool values and probabilities in f32, the fresh
    k/v as rounded to x.dtype); tokens no row covers get a zero
    attention output."""
    q, k_new, v_new = layer_qkv_reference(
        x, layer, sin, cos, eps=eps, n_heads=n_heads, n_kv_heads=n_kv_heads)
    ao = ragged_paged_attention_plain(
        q, k_new, v_new, k_pools, v_pools, int(layer_idx), row_slot,
        row_start, row_len, row_off, block_tables, soft_cap=soft_cap,
        k_scales=k_scales, v_scales=v_scales)
    x_out = layer_mlp_reference(x, ao, layer, eps=eps, n_heads=n_heads)
    return x_out, k_new, v_new


def fused_ragged_layer(
    x: torch.Tensor, layer, k_pools: torch.Tensor, v_pools: torch.Tensor,
    layer_idx: int, row_slot: torch.Tensor, row_start: torch.Tensor,
    row_len: torch.Tensor, row_off: torch.Tensor,
    block_tables: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, *,
    eps: float, n_heads: int, n_kv_heads: int,
    soft_cap: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    max_row_tokens: Optional[int] = None,
):
    """K7's fused layer over a ragged batch: x [T, D] (f32 or bf16, the
    dot dtype) → (x_out [T, D], k_new [T, KVH, hd], v_new [T, KVH, hd]),
    pools read-only, ``layer_idx`` a Python int, rows [R] and
    block_tables [slots, maxp] int32, sin/cos [T, hd//2] f32 per token.
    Every covered token attends to its slot's pooled past plus the causal
    prefix of its own row; tokens no row covers give garbage the caller
    masks.  ``max_row_tokens`` bounds the JAX kernel's VMEM window; the
    CUDA kernel needs none and ignores it.

    CUDA tensors launch kernel K8 (csrc/fused_ragged.cu; on int8 pools
    counted in ``launches_int8`` too); CPU tensors run the plain
    version."""
    quantized = _check_scales("fused_ragged_layer", k_pools, v_pools,
                              k_scales, v_scales)
    if not x.is_cuda:
        return fused_ragged_layer_reference(
            x, layer, k_pools, v_pools, layer_idx, row_slot, row_start,
            row_len, row_off, block_tables, sin, cos, eps=eps,
            n_heads=n_heads, n_kv_heads=n_kv_heads, soft_cap=soft_cap,
            k_scales=k_scales, v_scales=v_scales)
    rows = (row_slot, row_start, row_len, row_off)
    R = row_slot.shape[0]
    _check_cuda("fused_ragged_layer", row_slot=row_slot, row_start=row_start,
                row_len=row_len, row_off=row_off)
    if any(t.dtype != torch.int32 or t.shape != (R,) for t in rows):
        raise ValueError("fused_ragged_layer: rows must be int32 [R]")
    _, _, _, page, hd = k_pools.shape
    qpg = n_heads // n_kv_heads
    if hd not in _K8_HEAD_DIMS or qpg > _K8_QROWS:
        raise ValueError(f"fused_ragged_layer: unsupported head_dim {hd} "
                         f"(want one of {_K8_HEAD_DIMS}) or qpg {qpg} (max "
                         f"{_K8_QROWS})")
    tq = _K8_QROWS // qpg
    smem = 4 * ((_K8_QROWS + 2 * _K8_KEYS) * (hd + 4)
                + _K8_QROWS * (_K8_KEYS + 4) + 3 * _K8_QROWS)
    attn_plan = (0, 0)
    if x.dtype == torch.bfloat16 and _hopper_attention_ok(
            hd, page, qpg, R, k_pools, v_pools):
        attn_plan = hopper_attention_plan(x.shape[0], R, qpg,
                                          block_tables.shape[1], page)
        smem = 0
    out = launch_fused_layer(
        "fused_ragged", "rtt_fused_ragged_layer", x, layer, k_pools, v_pools,
        int(layer_idx), sin, cos, eps=eps, n_heads=n_heads,
        n_kv_heads=n_kv_heads, soft_cap=soft_cap,
        k_scales=k_scales if quantized else None,
        v_scales=v_scales if quantized else None,
        block_tables=block_tables, rows_desc=rows, tq=tq, attn_smem=smem,
        attn_plan=attn_plan)
    fused_ragged_layer.launches += 1
    if quantized:
        fused_ragged_layer.launches_int8 += 1
    return out


fused_ragged_layer.launches = 0
fused_ragged_layer.launches_int8 = 0
