"""Paged decode attention over a block-table KV cache (port of
``ray_tpu/ops/paged_attention.py``).

Layouts are the JAX package's:
  q            [B, H, D]                 one query token per slot
  k/v pools    [L, KVH, P, page, D]      kv-head-major per layer; the
                                         engine's pool has one extra
                                         physical page, the scratch page
  block_table  [B, maxp] int32           physical page per logical page;
                                         entries past a slot's live pages
                                         hold the OOB sentinel, never read
  lengths      [B] int32                 tokens already in the cache

int8 pools carry one f32 scale per physical page and kv head,
``k_scales``/``v_scales`` [L, P, KVH, 1] (page-major, unlike the
head-major pools); the true value is ``int8 * scale[layer, page, kvh]``.

Four kernels live here, each a CUDA kernel for Hopper (``csrc/``) with
its plain PyTorch version beside it: K1 ``paged_decode_attention_partial``
(bf16/f32 pools, and int8 pools with scales), K2 ``paged_append``, K3
``paged_append_quantized`` and K13 ``paged_decode_attention`` (normalised
attention over one layer's pages [KVH, P, page, D], which no model path
calls: ``paged_decode_attention_tp``'s no-mesh path reaches it).  A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
``combine_with_self`` is plain PyTorch, as it is plain jnp in the JAX
package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024
_EPL = 8  # columns of one partial sum of q·k (csrc: EPL)


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, **tensors: torch.Tensor) -> None:
    dev = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, want CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")


def _check_scales(name: str, k_pools: torch.Tensor, v_pools: torch.Tensor,
                  k_scales: Optional[torch.Tensor],
                  v_scales: Optional[torch.Tensor]) -> bool:
    """True when the call is on int8 pools with their page scales
    [L, P, KVH, 1] f32; raises on int8 pools without scales, on scales
    beside other pools and on a scale layout that does not fit."""
    quantized = k_scales is not None
    if (v_scales is not None) != quantized:
        raise ValueError(f"{name}: k_scales and v_scales come together")
    if (k_pools.dtype == torch.int8) != quantized:
        raise ValueError(f"{name}: int8 pools need k_scales/v_scales, and "
                         f"only int8 pools take them (pools {k_pools.dtype})")
    if quantized:
        L, KVH, P = k_pools.shape[:3]
        for key, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
            if sc.dtype != torch.float32 or sc.shape != (L, P, KVH, 1):
                raise ValueError(
                    f"{name}: {key} must be f32 [L, P, KVH, 1] = "
                    f"{(L, P, KVH, 1)}, got {sc.dtype} {tuple(sc.shape)}")
    return quantized


def _fixed_order_dot(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q·k [B, KVH, qpg, T] in f32 from qg [B, KVH, qpg, D] and k
    [B, KVH, T, D], summed in the fixed order of K1's and K13's kernels:
    the products of each eight consecutive columns left to right, then
    pairs of those n = ceil(D/8) partial sums, i and i + h for
    h = floor(n/2), an odd one out carried to the next round, until one
    is left (for D/8 a power of two: halving exchanges over lanes).
    Every product and sum is one rounded f32 operation, so the kernels
    reproduce this bit for bit."""
    D = qg.shape[-1]
    prod = qg.float()[:, :, :, None, :] * k.float()[:, :, None, :, :]
    n = -(-D // _EPL)
    if n * _EPL != D:  # zero columns add nothing
        prod = torch.nn.functional.pad(prod, (0, n * _EPL - D))
    x = prod.reshape(*prod.shape[:-1], n, _EPL)
    s = x[..., 0]
    for i in range(1, _EPL):
        s = s + x[..., i]
    while n > 1:
        h = n // 2
        s = torch.cat([s[..., :h] + s[..., h:2 * h], s[..., 2 * h:]], dim=-1)
        n -= h
    return s[..., 0]


# --------------------------------------------------------------------------
# K1: layered decode partials
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# The Hopper route of K1 and K13 (csrc/paged_decode.cu, paged_decode_hopper).
_HOPPER_QPG = (1, 2, 4, 8)            # query rows a group is padded to
_HOPPER_HEAD_DIMS = (16, 32, 64, 128)
_HOPPER_MAX_CLUSTER = 8               # the portable cluster size
_HOPPER_MAX_STAGES = 16
_HOPPER_RING_BYTES = 32 * 1024
_HOPPER_WARPS = 4
_HOPPER_STATIC_SMEM = 4096            # barriers and per-rank sums, rounded up


def hopper_decode_plan(B: int, KVH: int, qpg: int, D: int, page: int,
                       maxp: int, esize: int, partial: bool,
                       device: torch.device) -> Optional[Tuple[int, int, int]]:
    """The launch of ``paged_decode_hopper`` (K1 when ``partial``, else
    K13): (cluster size, pages per CTA, ring stages), or None for a shape
    it does not take (qpg above 8, D outside {16, 32, 64, 128}, or a CTA's
    pages and scores beyond the H100's shared memory even in a cluster of
    8).  A (slot, kv head) splits its page axis over a cluster of up to 8
    CTAs, enough for about four CTAs per SM; the ring holds all of a CTA's
    k and v pages when they fit in 32 KB, else as many as fit (at least
    2): a small ring leaves room for more CTAs on an SM.  ``esize`` is the
    pages' element size (1 for int8 pools); the group's qpg rows are padded
    to the next of 1, 2, 4, 8 inside the kernel."""
    if qpg > _HOPPER_QPG[-1] or D not in _HOPPER_HEAD_DIMS:
        return None
    qpg_p = next(n for n in _HOPPER_QPG if n >= qpg)
    want = -(-4 * _sm_count(device.index or 0) // max(B * KVH, 1))
    top = max(1, min(_HOPPER_MAX_CLUSTER, maxp))
    stage = page * D * esize
    for csize in range(max(1, min(top, want)), top + 1):
        ppc = -(-maxp // csize)
        csize = -(-maxp // ppc)
        stages = max(2, min(2 * ppc, _HOPPER_MAX_STAGES,
                            _HOPPER_RING_BYTES // stage))
        smem = (max(stages * stage, 4 * _HOPPER_WARPS * qpg_p * D)
                + 4 * (qpg_p * ppc * page + csize * qpg_p * D
                       + (2 * ppc * qpg_p if partial else 0)))
        if smem + _HOPPER_STATIC_SMEM <= _SMEM_LIMIT:
            return csize, ppc, stages
    return None


# The page-walk route of K1 and K13 (csrc/paged_decode.cu,
# page_walk_kernel): every shape the Hopper route does not take.
_WALK_ACCUMULATORS = 256 * 4          # THREADS * MAX_E: rows · D per CTA
_WALK_MAX_D = 256


def walk_plan(name: str, qpg: int, D: int, page: int) -> Tuple[int, int]:
    """The launch of ``page_walk_kernel``: (query rows a CTA holds, whether
    k and v are staged one after the other).  A CTA holds at most
    ⌊1024 / D⌋ of the group's rows (its accumulators), so a group of any
    size splits over CTAs that each walk the slot's pages; a page's k and
    v are staged together in f32 shared memory when they fit, else k and
    then v in one buffer, else fewer rows.  Raises for D above 256 or a
    page beyond the H100's shared memory even so."""
    if not 1 <= D <= _WALK_MAX_D:
        raise ValueError(f"{name}: unsupported D={D} (the page-walk route "
                         f"takes head dims 1 to {_WALK_MAX_D})")
    Dp = -(-D // _EPL) * _EPL
    rows = min(qpg, _WALK_ACCUMULATORS // D)
    while True:
        for split in (0, 1):
            smem = 4 * (page * (Dp + 4) + (0 if split else page * D)
                        + rows * Dp + rows * page + 3 * rows)
            if smem <= _SMEM_LIMIT:
                return rows, split
        if rows == 1:
            raise ValueError(f"{name}: a page of {page} x D {D} needs "
                             f"{smem} B of shared memory on the page-walk "
                             "route, over the H100's 227 KB")
        rows = -(-rows // 2)


def paged_decode_attention_partial_plain(
    q: torch.Tensor, k_pools: torch.Tensor, v_pools: torch.Tensor,
    layer: int, block_table: torch.Tensor, lengths: torch.Tensor, *,
    soft_cap: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1: the Pallas body's walk over a slot's pages in
    order, every slot and head at once, with the online softmax in f32.
    Per page: s = q·k · D^-0.5 (times the page's k scale on int8 pools,
    then the soft cap and the mask), m_new = max(m, page max),
    p = exp(s - m_new), corr = exp(m - m_new), l = corr·l + Σp with p
    unrounded, then p rounded to q's dtype and acc = acc·corr + p·v
    (p·v times the page's v scale on int8 pools).  A slot with length 0
    returns acc = 0, m = -1e30, l = 0, as the kernel does.

    The q·k dot is summed in the kernels' fixed order (``_fixed_order_dot``);
    the exponentials and the soft cap's tanh are taken in f64 and rounded
    once to f32.  So every f32 value up to p is the kernel's, and the
    two round p identically."""
    B, H, D = q.shape
    _, KVH, P, page, _ = k_pools.shape
    maxp = block_table.shape[1]
    qpg = H // KVH
    bt = block_table.long().clamp(0, P - 1)
    lens = lengths.to(q.device).long()
    qg = q.reshape(B, KVH, qpg, D)
    dev = q.device
    acc = torch.zeros((B, KVH, qpg, D), dtype=torch.float32, device=dev)
    m = torch.full((B, KVH, qpg, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, qpg, 1), dtype=torch.float32, device=dev)
    pos = torch.arange(page, device=dev)
    for j in range(maxp):
        pid = bt[:, j]
        k = k_pools[layer][:, pid].transpose(0, 1)  # [B, KVH, page, D]
        v = v_pools[layer][:, pid].transpose(0, 1)
        s = _fixed_order_dot(qg, k) * (D ** -0.5)
        if k_scales is not None:
            s = s * k_scales[layer, pid, :, 0][:, :, None, None]
        if soft_cap is not None:
            s = torch.tanh((s / s.new_tensor(soft_cap)).double()).float() \
                * soft_cap
        valid = (j * page + pos)[None, :] < lens[:, None]      # [B, page]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s.double() - m_new.double()).float()
        corr = torch.exp(m.double() - m_new.double()).float()
        pv = torch.einsum("bgqk,bgkd->bgqd", p.to(q.dtype).float(),
                          v.float())
        if v_scales is not None:
            pv = pv * v_scales[layer, pid, :, 0][:, :, None, None]
        live = (j * page < lens)[:, None, None, None]
        l = torch.where(live, corr * l + p.sum(dim=-1, keepdim=True), l)
        acc = torch.where(live, acc * corr + pv, acc)
        m = torch.where(live, m_new, m)
    return (acc.reshape(B, H, D), m.reshape(B, H, 1), l.reshape(B, H, 1))


def paged_decode_attention_partial(
    q: torch.Tensor, k_pools: torch.Tensor, v_pools: torch.Tensor,
    layer: int, block_table: torch.Tensor, lengths: torch.Tensor, *,
    soft_cap: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Read-only layered attention over PAST tokens only:
    q [B, H, D], pools [L, KVH, P, page, D], ``layer`` a Python int,
    lengths = tokens already in the cache → (acc [B, H, D] f32
    unnormalised, m [B, H, 1], l [B, H, 1]).  Combine with the new
    token's self term via ``combine_with_self``.

    int8 pools: pass ``k_scales``/``v_scales`` [L, P, KVH, 1] f32 (one
    scale per physical page per kv head); q stays f32 or bf16.

    CUDA tensors launch kernel K1 (csrc/paged_decode.cu; its int8
    instantiation when scales are given, counted in ``launches_int8``
    too) on one of two routes, chosen by shape: ``paged_decode_hopper``
    (D in {16, 32, 64, 128}, qpg up to 8, pages within shared memory: one
    launch, a cluster of CTAs per (slot, kv head) over the pages, bulk
    copies into shared memory), else ``page_walk_kernel`` (any qpg, D up
    to 256: one CTA per (slot, kv head, block of query rows) walking the
    pages in order, ``walk_plan``; counted in ``launches_walk`` too); D
    above 256 raises.  CPU tensors run the plain version."""
    quantized = _check_scales("paged_decode_attention_partial", k_pools,
                              v_pools, k_scales, v_scales)
    if not q.is_cuda:
        return paged_decode_attention_partial_plain(
            q, k_pools, v_pools, layer, block_table, lengths,
            soft_cap=soft_cap, k_scales=k_scales, v_scales=v_scales)
    B, H, D = q.shape
    L, KVH, P, page, Dk = k_pools.shape
    maxp = block_table.shape[1]
    _check_cuda("paged_decode_attention_partial", q=q, k_pools=k_pools,
                v_pools=v_pools, block_table=block_table, lengths=lengths)
    if quantized:
        _check_cuda("paged_decode_attention_partial", k_scales=k_scales,
                    v_scales=v_scales)
    pool_dt = torch.int8 if quantized else q.dtype
    if q.dtype not in _DTYPE_CODE or k_pools.dtype != pool_dt \
            or v_pools.dtype != pool_dt:
        raise ValueError("paged_decode_attention_partial: q must be f32 or "
                         "bf16 and the pools of q's dtype (int8 with "
                         f"scales), got {q.dtype}, {k_pools.dtype}, "
                         f"{v_pools.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_table and lengths must be int32")
    if (v_pools.shape != k_pools.shape or Dk != D or H % KVH
            or block_table.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(
            f"paged_decode_attention_partial: bad shapes q {tuple(q.shape)}, "
            f"pools {tuple(k_pools.shape)}, block_table "
            f"{tuple(block_table.shape)}, lengths {tuple(lengths.shape)}")
    qpg = H // KVH
    if not 0 <= layer < L:
        raise ValueError(f"paged_decode_attention_partial: layer {layer} "
                         f"out of [0, {L})")
    acc = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    if B == 0:
        return acc, m, l
    if maxp == 0:
        return acc.zero_(), m.fill_(NEG_INF), l.zero_()
    plan = hopper_decode_plan(B, KVH, qpg, D, page, maxp,
                              k_pools.element_size(), True, q.device)
    lib = _build.library("paged_decode")
    common = (q.data_ptr(), k_pools.data_ptr(), v_pools.data_ptr(),
              k_scales.data_ptr() if quantized else None,
              v_scales.data_ptr() if quantized else None,
              block_table.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
              m.data_ptr(), l.data_ptr(), _DTYPE_CODE[q.dtype], B, KVH, P,
              page, D, qpg, maxp)
    tail = (D ** -0.5, float(soft_cap) if soft_cap is not None else 0.0,
            _stream_ptr(q))
    if plan is not None:
        fn = lib.rtt_paged_decode_partial
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        args = common + (*plan, int(layer)) + tail
    else:
        fn = lib.rtt_paged_decode_partial_walk
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        args = common + (*walk_plan("paged_decode_attention_partial", qpg,
                                    D, page), int(layer)) + tail
    fn.restype = ctypes.c_int
    _build.check(fn(*args), "paged_decode_attention_partial")
    paged_decode_attention_partial.launches += 1
    if quantized:
        paged_decode_attention_partial.launches_int8 += 1
    if plan is None:
        paged_decode_attention_partial.launches_walk += 1
    return acc, m, l


paged_decode_attention_partial.launches = 0
paged_decode_attention_partial.launches_int8 = 0
paged_decode_attention_partial.launches_walk = 0  # of them on the walk


def combine_with_self(q, k_new, v_new, acc, m, l, *,
                      scale: Optional[float] = None,
                      soft_cap: Optional[float] = None) -> torch.Tensor:
    """Fold the CURRENT token's self-attention into flash partials:
    q [B, H, D], k_new/v_new [B, KVH, D] (GQA-expanded here),
    (acc, m, l) from paged_decode_attention_partial → out [B, H, D]."""
    B, H, D = q.shape
    group = H // k_new.shape[1]
    kx = k_new.repeat_interleave(group, dim=1).float()
    vx = v_new.repeat_interleave(group, dim=1).float()
    scale = scale if scale is not None else D ** -0.5
    s = (q.float() * kx).sum(dim=-1, keepdim=True) * scale
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    m_new = torch.maximum(m, s)
    corr = torch.exp(m - m_new)
    p_self = torch.exp(s - m_new)
    out = (acc * corr + p_self * vx) / (l * corr + p_self)
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# K2: in-place append of one row per slot, all layers
# --------------------------------------------------------------------------

def paged_append_plain(k_pools, v_pools, k_new, v_new, pids, offs) -> None:
    """Plain version of K2 (index assignment in place); page ids clamp
    to the last physical page, the scratch page."""
    P = k_pools.shape[2]
    pid = pids.long().clamp(0, P - 1)
    off = offs.long()
    k_pools[:, :, pid, off] = k_new.permute(0, 2, 1, 3).to(k_pools.dtype)
    v_pools[:, :, pid, off] = v_new.permute(0, 2, 1, 3).to(v_pools.dtype)


def paged_append(k_pools: torch.Tensor, v_pools: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pids: torch.Tensor, offs: torch.Tensor) -> None:
    """Append one token per slot into the page pools, for EVERY layer
    at once, IN PLACE: pools [L, KVH, P, page, D],
    k_new/v_new [L, B, KVH, D], pids/offs [B] int32.  A page id ≥ P - 1
    writes the last physical page (the scratch page: the OOB convention
    for inactive slots).  The caller owns the pools and sees them
    mutated; nothing is returned.

    CUDA tensors launch kernel K2 (csrc/paged_append.cu); CPU tensors
    run the plain version."""
    if not k_pools.is_cuda:
        paged_append_plain(k_pools, v_pools, k_new, v_new, pids, offs)
        return
    L, KVH, P, page, D = k_pools.shape
    B = pids.shape[0]
    _check_cuda("paged_append", k_pools=k_pools, v_pools=v_pools,
                k_new=k_new, v_new=v_new, pids=pids, offs=offs)
    dt = k_pools.dtype
    if dt not in _DTYPE_CODE or v_pools.dtype != dt or k_new.dtype != dt \
            or v_new.dtype != dt:
        raise ValueError("paged_append: pools and new rows must share dtype "
                         f"f32 or bf16, got {dt}, {v_pools.dtype}, "
                         f"{k_new.dtype}, {v_new.dtype}")
    if pids.dtype != torch.int32 or offs.dtype != torch.int32:
        raise ValueError("pids and offs must be int32")
    if (v_pools.shape != k_pools.shape or k_new.shape != (L, B, KVH, D)
            or v_new.shape != k_new.shape or offs.shape != (B,)):
        raise ValueError(
            f"paged_append: bad shapes pools {tuple(k_pools.shape)}, new "
            f"{tuple(k_new.shape)}, pids {tuple(pids.shape)}, offs "
            f"{tuple(offs.shape)}")
    row_bytes = D * k_pools.element_size()
    if row_bytes % 16 or row_bytes > 16 * 1024:
        raise ValueError(f"paged_append: a row of {row_bytes} B is not a "
                         "multiple of 16 up to 16 KB")
    if B == 0:
        return
    lib = _build.library("paged_append")
    fn = lib.rtt_paged_append
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    err = fn(k_pools.data_ptr(), v_pools.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), pids.data_ptr(), offs.data_ptr(), L, B, KVH,
             P, page, row_bytes, _stream_ptr(k_pools))
    _build.check(err, "paged_append")
    paged_append.launches += 1


paged_append.launches = 0


# --------------------------------------------------------------------------
# K3: in-place int8 append of one row per slot, all layers
# --------------------------------------------------------------------------

# The quantisers divide by a TENSOR of 127s: a tensor divided by a Python
# scalar is a product with the reciprocal on a CUDA tensor, one ulp off
# the true quotient that the CPU, the JAX package and the kernels compute.

def _quant_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even and clip to the symmetric int8 range."""
    return torch.round(x).clamp(-127, 127)


def paged_append_quantized_plain(k_pools, v_pools, k_scales, v_scales,
                                 k_new, v_new, pids, offs) -> None:
    """Plain version of K3, in place.  Per (slot, layer, kv head), for k
    and v alike: the page's scale grows to fit the new row's absmax / 127
    (no floor: an all-zero row keeps a zero scale and divides by 1); a
    grown scale requantises the page's stored bytes by old / new, a
    stable one leaves them untouched; a write at offset 0 starts the page
    fresh (stale bytes zeroed, scale reset to the row's own).  The row is
    quantised by multiplying with 1 / scale."""
    P = k_pools.shape[2]
    B = pids.shape[0]
    pid = pids.long().clamp(0, P - 1)
    off = offs.long()
    fresh = (off == 0)[None, :, None]
    slots = torch.arange(B, device=pid.device)
    for pools, scales, new in ((k_pools, k_scales, k_new),
                               (v_pools, v_scales, v_new)):
        row = new.float()                                 # [L, B, KVH, D]
        amax = row.abs().amax(dim=-1)                     # [L, B, KVH]
        needed = amax / torch.full_like(amax, 127.0)
        old = scales[:, pid, :, 0]
        new_scale = torch.where(fresh, needed, torch.maximum(old, needed))
        safe = torch.where(new_scale == 0.0, torch.ones_like(new_scale),
                           new_scale)
        factor = torch.where(
            fresh, torch.zeros_like(old),
            torch.where(new_scale > old, old / safe, torch.ones_like(old)))
        cur = pools[:, :, pid].float()                    # [L, KVH, B, pg, D]
        out = torch.round(cur * factor.permute(0, 2, 1)[..., None, None])
        row_q = _quant_round(row * (1.0 / safe)[..., None])
        out[:, :, slots, off] = row_q.permute(0, 2, 1, 3)
        pools[:, :, pid] = out.clamp(-127, 127).to(torch.int8)
        scales[:, pid, :, 0] = new_scale


def paged_append_quantized(k_pools: torch.Tensor, v_pools: torch.Tensor,
                           k_scales: torch.Tensor, v_scales: torch.Tensor,
                           k_new: torch.Tensor, v_new: torch.Tensor,
                           pids: torch.Tensor, offs: torch.Tensor) -> None:
    """Append one token per slot into int8 page pools, for EVERY layer at
    once, IN PLACE on pools and scales: pools int8 [L, KVH, P, page, D],
    scales f32 [L, P, KVH, 1], k_new/v_new [L, B, KVH, D] f32 or bf16,
    pids/offs [B] int32.  A page id ≥ P - 1 writes the scratch page
    (several inactive slots may race there: its bytes are garbage by
    contract, its scale stays finite).  Nothing is returned.

    CUDA tensors launch kernel K3 (csrc/paged_append_quantized.cu); CPU
    tensors run the plain version."""
    _check_scales("paged_append_quantized", k_pools, v_pools, k_scales,
                  v_scales)
    if not k_pools.is_cuda:
        paged_append_quantized_plain(k_pools, v_pools, k_scales, v_scales,
                                     k_new, v_new, pids, offs)
        return
    L, KVH, P, page, D = k_pools.shape
    B = pids.shape[0]
    _check_cuda("paged_append_quantized", k_pools=k_pools, v_pools=v_pools,
                k_scales=k_scales, v_scales=v_scales, k_new=k_new,
                v_new=v_new, pids=pids, offs=offs)
    if k_new.dtype not in _DTYPE_CODE or v_new.dtype != k_new.dtype:
        raise ValueError("paged_append_quantized: new rows must share dtype "
                         f"f32 or bf16, got {k_new.dtype}, {v_new.dtype}")
    if pids.dtype != torch.int32 or offs.dtype != torch.int32:
        raise ValueError("pids and offs must be int32")
    if (v_pools.shape != k_pools.shape or k_new.shape != (L, B, KVH, D)
            or v_new.shape != k_new.shape or offs.shape != (B,)):
        raise ValueError(
            f"paged_append_quantized: bad shapes pools "
            f"{tuple(k_pools.shape)}, new {tuple(k_new.shape)}, pids "
            f"{tuple(pids.shape)}, offs {tuple(offs.shape)}")
    if D % 16 or D > 1024:
        raise ValueError(f"paged_append_quantized: an int8 row of {D} B is "
                         "not a multiple of 16 up to 1024")
    if B == 0:
        return
    lib = _build.library("paged_append_quantized")
    fn = lib.rtt_paged_append_quantized
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    err = fn(k_pools.data_ptr(), v_pools.data_ptr(), k_scales.data_ptr(),
             v_scales.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
             pids.data_ptr(), offs.data_ptr(), _DTYPE_CODE[k_new.dtype], L,
             B, KVH, P, page, D, _stream_ptr(k_pools))
    _build.check(err, "paged_append_quantized")
    paged_append_quantized.launches += 1


paged_append_quantized.launches = 0


# --------------------------------------------------------------------------
# K13: normalised decode attention over one layer's pages
# --------------------------------------------------------------------------

_LOG2E = 1.4426950408889634  # csrc: pdh::LOG2E


def paged_decode_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_table: torch.Tensor, lengths: torch.Tensor, *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of K13 at the Pallas body's rounding points: s, m, l
    and acc in f32, p rounded to the pages' dtype before p·v, then acc / l
    in q's dtype (l = 0, a slot with no token, divides by 1: the row is
    0).  p is taken against the power of two just above the slot's max,
    p = 2^(y - M) with y = s·log2(e) and M = ceil(max y), as K13 takes it
    (rounding commutes with a power of two, so K13's page splits, each at
    its own M, round p exactly as here); the Pallas body takes exp(s - m)
    at its running max m.  Either way p is within a factor 2 of the
    other, so the two round p to within one bf16 ulp of each other.

    The q·k dot is summed in the kernels' order (``_fixed_order_dot``); y, exp2 and
    tanh are taken in f64 and rounded once to f32; the soft cap divides
    by a tensor (a Python scalar divisor on a CUDA tensor becomes a
    product with its reciprocal).  So every f32 value up to the rounded p
    is the kernel's, and the two round p identically."""
    B, H, D = q.shape
    KVH, P, page, _ = k_pages.shape
    maxp = block_table.shape[1]
    bt = block_table.long().clamp(0, P - 1)
    k = k_pages[:, bt].permute(1, 0, 2, 3, 4).reshape(B, KVH, maxp * page, D)
    v = v_pages[:, bt].permute(1, 0, 2, 3, 4).reshape(B, KVH, maxp * page, D)
    s = _fixed_order_dot(q.reshape(B, KVH, H // KVH, D), k) * (D ** -0.5)
    if soft_cap is not None:
        s = torch.tanh((s / s.new_tensor(soft_cap)).double()).float() \
            * soft_cap
    pos = torch.arange(maxp * page, device=q.device)
    valid = (pos[None, :] < lengths.to(q.device).long()[:, None])
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    y = s.double() * _LOG2E
    m_ref = torch.ceil(y.amax(dim=-1, keepdim=True))
    p = torch.where(valid, torch.exp2(y - m_ref).float(), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgqk,bgkd->bgqd", p.to(v_pages.dtype).float(),
                       v.float())
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_table: torch.Tensor, lengths: torch.Tensor, *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """q [B, H, D], k/v_pages [KVH, P, page, D] (one layer, q's dtype,
    f32 or bf16), block_table [B, maxp] int32, lengths [B] int32 (every
    token, the current one included) → out [B, H, D] in q's dtype.  Page
    ids clamp to P - 1; a slot with length 0 gives 0.

    CUDA tensors launch kernel K13 (csrc/paged_decode.cu) on one of two
    routes, chosen by shape as K1's: ``paged_decode_hopper`` (one launch,
    a cluster of CTAs per (slot, kv head) over the pages, bulk copies into
    shared memory; a group of qpg up to 8 rows is padded to 1, 2, 4 or 8
    with zero rows whose results are dropped, as the Pallas kernel pads to
    8; D in {16, 32, 64, 128}), else ``page_walk_kernel`` (any qpg, D up
    to 256, ``walk_plan``; counted in ``launches_walk`` too); D above 256
    raises.  CPU tensors run the plain version."""
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_pages, v_pages, block_table,
                                            lengths, soft_cap=soft_cap)
    B, H, D = q.shape
    KVH, P, page, Dk = k_pages.shape
    maxp = block_table.shape[1]
    _check_cuda("paged_decode_attention", q=q, k_pages=k_pages,
                v_pages=v_pages, block_table=block_table, lengths=lengths)
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError("paged_decode_attention: q and the pages must share "
                         f"dtype f32 or bf16, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_table and lengths must be int32")
    if (v_pages.shape != k_pages.shape or Dk != D or H % KVH
            or block_table.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(
            f"paged_decode_attention: bad shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}, block_table "
            f"{tuple(block_table.shape)}, lengths {tuple(lengths.shape)}")
    qpg = H // KVH
    out = torch.empty_like(q)
    if B == 0:
        return out
    if maxp == 0:
        return out.zero_()
    plan = hopper_decode_plan(B, KVH, qpg, D, page, maxp, q.element_size(),
                              False, q.device)
    walk = plan is None
    if walk:
        plan = walk_plan("paged_decode_attention", qpg, D, page)
    lib = _build.library("paged_decode")
    fn = (lib.rtt_paged_decode_attention_walk if walk
          else lib.rtt_paged_decode_attention)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * (8 + len(plan))
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             _DTYPE_CODE[q.dtype], B, KVH, P, page, D, qpg, maxp, *plan,
             D ** -0.5,
             float(soft_cap) if soft_cap is not None else 0.0,
             _stream_ptr(q))
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    if walk:
        paged_decode_attention.launches_walk += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.launches_walk = 0  # of them on the page walk


def paged_decode_attention_tp(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_table: torch.Tensor, lengths: torch.Tensor, *,
    soft_cap: Optional[float] = None, mesh: Any = None,
) -> torch.Tensor:
    """The JAX package's tensor-parallel entry.  Without a mesh it is K13
    itself (the JAX no-mesh fallback); any mesh raises
    NotImplementedError: tensor parallelism is not ported yet (ROADMAP.md
    queue 1 item 6 part 3)."""
    if mesh is not None:
        raise NotImplementedError(
            "paged_decode_attention_tp over a mesh: tensor parallelism is "
            "not ported to ray_tpu_torch yet (ROADMAP.md queue 1 item 6 "
            "part 3)")
    return paged_decode_attention(q, k_pages, v_pages, block_table, lengths,
                                  soft_cap=soft_cap)


def paged_decode_attention_reference(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_table: torch.Tensor, lengths: torch.Tensor, *,
    soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Dense reference for one layer's pages [KVH, P, page, D]: gather,
    masked softmax attention, normalised → [B, H, D] (test oracle)."""
    B, H, D = q.shape
    KVH, P, page, _ = k_pages.shape
    maxp = block_table.shape[1]
    bt = block_table.long()
    k = k_pages[:, bt].permute(1, 2, 3, 0, 4).reshape(B, maxp * page, KVH, D)
    v = v_pages[:, bt].permute(1, 2, 3, 0, 4).reshape(B, maxp * page, KVH, D)
    group = H // KVH
    kx = k.repeat_interleave(group, dim=2).float()
    vx = v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kx) * (D ** -0.5)
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    ki = torch.arange(maxp * page, device=q.device)[None, None, :]
    s = torch.where(ki < lengths.long()[:, None, None], s,
                    torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, vx)
    return out.to(q.dtype)
