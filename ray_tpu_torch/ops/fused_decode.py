"""Fused per-layer decode kernel K7 (port of ``ray_tpu/ops/fused_decode.py``).

One call runs a whole decoder layer for one query token per slot:

    RMSNorm -> qkv projection -> RoPE -> paged attention over the slot's
    pages -> the token's self term -> o-proj + residual -> RMSNorm ->
    gate/up/SiLU/down + residual

and returns ``(x_out [B, D], k_new [B, KVH, hd], v_new [B, KVH, hd])``.
The contracts are the JAX kernel's: the pools are STRICTLY read-only (the
caller appends every layer's fresh rows after the layer loop), the page
table, OOB sentinel and per-page-per-kv-head int8 scales are
``ops/paged_attention.py``'s, and int8 weights stay ``{"q", "scale"}``
per output column, their scale applied to the matmul RESULT so only int8
bytes leave device memory.

Rounding points are the Pallas kernel's, not the unfused path's: the
norm runs in f32 and its output is cast to the dot dtype (``x.dtype``);
qkv stays f32 after its scale; RoPE runs in f32 and only k_new/v_new are
rounded; the page dots take q and the page in the dot dtype and the
probabilities are rounded to it for p.v; the self term uses the f32 q
against the rounded fresh k/v; h stays f32 through the MLP and x_out is
rounded once.  In bf16 the fused and unfused paths therefore differ.

For CUDA tensors ``fused_decode_layer`` launches K7
(``csrc/fused_decode.cu`` with the phase kernels of
``csrc/fused_layer.cuh``): weights are read in place, separate q/k/v or
gate/up leaves as column segments of one projection, never concatenated
per call.  With bf16 activations and int8 or bf16 weights whose segments
are multiples of 64 columns, each projection is one Hopper launch
(``wgmma_plan``: every token of the call shares each weight tile, and K
splits over a cluster that sums in rank order); a call of at most 64
tokens over int8 weights takes the DECODE route instead (``decode_plan``:
one CTA an SM streaming equal shares of the weights, partial tiles
summed in a fixed order), and with bf16 activations at head_dim 128 the
attention runs on the tensor cores.  CPU tensors run the
plain version, ``fused_decode_layer_reference``, which may concatenate.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.paged_attention import (
    _SMEM_LIMIT,
    NEG_INF,
    _check_cuda,
    _check_scales,
    _sm_count,
    _stream_ptr,
)

_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# Projection routes of csrc/fused_layer.cuh (Proj::route).
_CUDA_CORES, _WGMMA, _DECODE = 0, 1, 2
# The CUDA-core route's tile, (rows, columns) per CTA (the wrapper sizes
# its split-K plan and partial buffer by it).
_FMA_TILE = (16, 512)
_MIN_K_PER_SPLIT = 256
# WGMMA route: (tokens of one wgmma, wgmmas a tile), smallest first; a
# call of more tokens than the last takes several token tiles.
_WGMMA_TILES = ((64, 1), (136, 1), (136, 2))
_WGMMA_SMEM = 225 * 1024   # dynamic shared memory a CTA may take
_WGMMA_MAX_STAGES = 8
# DECODE route (csrc/fused_layer.cuh proj_decode): calls of at most this
# many tokens, int8 weights; 256 output columns a tile (SwiGLU: 128 gate
# and 128 up), 64 K a step; ring stages of two [64][128] int8 boxes and
# the step's activations.
DECODE_MAX_ROWS = 64
_DECODE_MAX_STAGES = 12


def wgmma_plan(rows: int, K: int, cols: int, weight_bytes: int,
               sms: int) -> dict:
    """The WGMMA route's plan for one projection: ``nw`` tokens a wgmma
    and ``nc`` wgmmas a token tile (``token_tiles`` of them), ``col_tiles``
    tiles of 128 output columns (SwiGLU: 64 gate/up pairs), K split into
    ``splits`` runs of ``kps`` (a multiple of 64; the cluster size, at
    most 8, enough for about one CTA per SM), and ``stages`` ring stages
    of ``stage_bytes``."""
    nw, nc = next((t for t in _WGMMA_TILES if t[0] * t[1] >= rows),
                  _WGMMA_TILES[-1])
    nt = nw * nc
    token_tiles = -(-rows // nt)
    col_tiles = cols // 128
    want = max(1, min(8, sms // (col_tiles * token_tiles)))
    per = -(-K // want)
    kps = -(-per // 64) * 64
    stage = nt * 128 + 2 * 64 * 64 * 2 + (2 * 64 * 64 if weight_bytes == 1
                                          else 0)
    stages = min(_WGMMA_MAX_STAGES, _WGMMA_SMEM // stage)
    assert stages >= 2 and stages * stage >= nt * 132 * 4
    return {"nw": nw, "nc": nc, "token_tiles": token_tiles,
            "col_tiles": col_tiles, "splits": -(-K // kps), "kps": kps,
            "stages": stages, "stage_bytes": stage}


@functools.lru_cache(maxsize=None)
def decode_plan(rows: int, K: int, cols: int, sms: int) -> dict:
    """The DECODE route's plan for one projection (cached: the wrapper
    asks for it on every call; treat it as read-only): ``nt`` tokens of
    one wgmma (rows rounded up to 8), ``tiles`` column tiles of 256
    columns (SwiGLU: 128 gate/up pairs; the tile count is cols / 256
    either way), ``ksteps`` 64-K steps a tile, ``units`` = tiles x ksteps
    cut into ``grid`` equal contiguous shares (one CTA an SM; csrc:
    unit_start), ``stages`` ring stages of ``stage_bytes`` and the
    kernel's dynamic shared memory ``smem``, and ``part_floats``, the f32
    slots of the tiles that CTAs share."""
    if not 0 < rows <= DECODE_MAX_ROWS or K % 64 or cols % 256:
        raise ValueError(f"decode_plan: rows {rows}, K {K}, cols {cols}")
    nt = -(-rows // 8) * 8
    tiles, ksteps = cols // 256, K // 64
    units = tiles * ksteps
    grid = min(sms, units)
    stage = 2 * 64 * 128 + nt * 128
    xch = nt * 128 * 4                     # the SwiGLU exchange
    stages = min(_DECODE_MAX_STAGES, (_WGMMA_SMEM - 1024 - xch) // stage)
    assert stages >= 2
    return {"nt": nt, "tiles": tiles, "ksteps": ksteps, "units": units,
            "grid": grid, "stages": stages,
            "stage_bytes": stage, "smem": stages * stage + xch + 1024,
            "part_floats": grid * 2 * 256 * nt}


def _qdict(node) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {"q", "scale"}


# --------------------------------------------------------------------------
# operands (plain version: one [K, cols] operand and [1, cols] scale)
# --------------------------------------------------------------------------

def _weight_pair(leaf, cols_of_hd: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(operand [K, N], per-output-column scale [1, N]) from a param
    leaf.  Quantised ``{"q", "scale"}`` leaves pass int8 through (the
    scale applies to the matmul RESULT); plain leaves get a ones scale.
    ``cols_of_hd`` tiles a per-head-dim scale ([1, .., hd] from unfused
    per-weight quantisation) across that many heads."""
    if _qdict(leaf):
        q = leaf["q"]
        s = leaf["scale"].reshape(1, -1).float()
        q = q.reshape(q.shape[0], -1)
        if cols_of_hd is not None and s.shape[1] != q.shape[1]:
            s = s.repeat(1, cols_of_hd)
        return q, s
    w = leaf.reshape(leaf.shape[0], -1)
    return w, torch.ones((1, w.shape[1]), dtype=torch.float32,
                         device=w.device)


def _assemble(parts, dt):
    """Concatenate (leaf, heads) parts into one operand + scale, as the
    JAX kernel's wrapper does; mixed int8/plain parts are dequantised to
    ``dt`` with a ones scale (a test-path convenience)."""
    if all(_qdict(w) for w, _ in parts):
        ws, ss = zip(*(_weight_pair(w, n) for w, n in parts))
        return torch.cat(ws, dim=1), torch.cat(ss, dim=1)
    deq = []
    for w, _n in parts:
        if _qdict(w):
            w = w["q"].to(dt) * w["scale"].to(dt)
        deq.append(w.reshape(w.shape[0], -1).to(dt))
    w = torch.cat(deq, dim=1)
    return w, torch.ones((1, w.shape[1]), dtype=torch.float32,
                         device=w.device)


def _assemble_qkv(attn, H: int, KVH: int, hd: int, dt):
    """One [D, (H+2KVH)*hd] operand + [1, ...] scale from either the
    fused ``wqkv`` artifact or separate wq/wk/wv leaves."""
    if "wqkv" in attn:
        return _weight_pair(attn["wqkv"])
    return _assemble([(attn["wq"], H), (attn["wk"], KVH), (attn["wv"], KVH)],
                     dt)


def _assemble_gateup(mlp, dt):
    if "w_gateup" in mlp:
        return _weight_pair(mlp["w_gateup"])
    return _assemble([(mlp["w_gate"], None), (mlp["w_up"], None)], dt)


def _wo_pair(leaf, H: int, hd: int, D: int):
    """wo contracts over (heads, head_dim): both fold into rows."""
    if _qdict(leaf):
        return (leaf["q"].reshape(H * hd, D),
                leaf["scale"].reshape(1, D).float())
    return leaf.reshape(H * hd, D), torch.ones((1, D), dtype=torch.float32,
                                                device=leaf.device)


def _mlp_dim(layer) -> int:
    wd = layer["mlp"]["w_down"]
    return (wd["q"] if _qdict(wd) else wd).shape[0]


# --------------------------------------------------------------------------
# plain version (shared by K7 and K8)
# --------------------------------------------------------------------------

def _dot(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """a [.., K] f32 and w [K, N] both cast to the dot dtype, products
    summed in f32 (preferred_element_type=f32)."""
    return a.to(dt).float() @ w.to(dt).float()


def _norm(x32: torch.Tensor, ln: torch.Tensor, eps: float) -> torch.Tensor:
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return x32 * torch.rsqrt(var + eps) * ln.float()


def _rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
          ) -> torch.Tensor:
    """x [rows, heads, hd] f32, sin/cos [rows, hd//2] f32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sn, cs = sin[:, None, :].float(), cos[:, None, :].float()
    return torch.cat([x1 * cs - x2 * sn, x2 * cs + x1 * sn], dim=-1)


def layer_qkv_reference(x, layer, sin, cos, *, eps: float, n_heads: int,
                        n_kv_heads: int):
    """The layer's first phase, as the fused kernels compute it: (q
    [rows, H, hd] f32 after RoPE, k_new, v_new [rows, KVH, hd] rounded
    to x.dtype)."""
    rows, D = x.shape
    H, KVH = n_heads, n_kv_heads
    hd = D // H
    dt = x.dtype
    wqkv, sqkv = _assemble_qkv(layer["attn"], H, KVH, hd, dt)
    xn = _norm(x.float(), layer["ln_attn"], eps)
    qkv = _dot(xn, wqkv, dt) * sqkv
    q = qkv[:, :H * hd].reshape(rows, H, hd)
    k = qkv[:, H * hd:(H + KVH) * hd].reshape(rows, KVH, hd)
    v = qkv[:, (H + KVH) * hd:].reshape(rows, KVH, hd)
    return _rope(q, sin, cos), _rope(k, sin, cos).to(dt), v.to(dt)


def layer_mlp_reference(x, ao, layer, *, eps: float, n_heads: int):
    """The layer's last phases: o-proj + residual (h f32), RMSNorm,
    gate/up/SiLU/down + residual, x_out rounded to x.dtype once."""
    rows, D = x.shape
    H = n_heads
    hd = D // H
    dt = x.dtype
    wo, so = _wo_pair(layer["attn"]["wo"], H, hd, D)
    wg, sg = _assemble_gateup(layer["mlp"], dt)
    wd, sd = _weight_pair(layer["mlp"]["w_down"])
    h = x.float() + _dot(ao.reshape(rows, H * hd), wo, dt) * so
    xn = _norm(h, layer["ln_mlp"], eps)
    gu = _dot(xn, wg, dt) * sg
    M = gu.shape[1] // 2
    g, u = gu[:, :M], gu[:, M:]
    act = (g * torch.sigmoid(g)) * u
    return (h + _dot(act, wd, dt) * sd).to(dt)


def _capped(s: torch.Tensor, soft_cap: Optional[float]) -> torch.Tensor:
    if soft_cap is not None:
        return soft_cap * torch.tanh(s / soft_cap)
    return s


def _decode_attention_reference(q, k_new, v_new, k_pools, v_pools, layer,
                                block_tables, lengths, dt, soft_cap,
                                k_scales, v_scales) -> torch.Tensor:
    """K7's attention phase: page by page over each slot's live pages
    (the kernel's online-softmax order and rounding points), then the
    self term.  q [B, H, hd] f32 → ao [B, H, hd] f32."""
    B, H, hd = q.shape
    _, KVH, P, page, _ = k_pools.shape
    qpg = H // KVH
    scale = hd ** -0.5
    maxp = block_tables.shape[1]
    bt = block_tables.long().clamp(0, P - 1)
    lens = lengths.long()
    qd = q.to(dt).float().reshape(B, KVH, qpg, hd)
    m = torch.full((B, KVH, qpg, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, KVH, qpg, 1), device=q.device)
    acc = torch.zeros((B, KVH, qpg, hd), device=q.device)
    pos_in_page = torch.arange(page, device=q.device)
    for p in range(maxp):
        live = (p * page < lens)[:, None, None, None]       # [B,1,1,1]
        pid = bt[:, p]
        kp = k_pools[layer][:, pid].permute(1, 0, 2, 3).to(dt).float()
        vp = v_pools[layer][:, pid].permute(1, 0, 2, 3).to(dt).float()
        s = torch.einsum("bgqd,bgkd->bgqk", qd, kp) * scale
        if k_scales is not None:
            s = s * k_scales[layer][pid][:, :, :, None]       # [B,KVH,1,1]
        s = _capped(s, soft_cap)
        valid = (p * page + pos_in_page)[None, :] < lens[:, None]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        probs = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = corr * l + probs.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bgqk,bgkd->bgqd", probs.to(dt).float(), vp)
        if v_scales is not None:
            pv = pv * v_scales[layer][pid][:, :, :, None]
        acc = torch.where(live, acc * corr + pv, acc)
        l = torch.where(live, l_new, l)
        m = torch.where(live, m_new, m)
    kh = k_new.float()[:, :, None, :]                        # [B,KVH,1,hd]
    vh = v_new.float()[:, :, None, :]
    qf = q.reshape(B, KVH, qpg, hd)
    s = _capped((qf * kh).sum(dim=-1, keepdim=True) * scale, soft_cap)
    m_new = torch.maximum(m, s)
    corr = torch.exp(m - m_new)
    p_self = torch.exp(s - m_new)
    o = (acc * corr + p_self * vh) / (l * corr + p_self)
    return o.reshape(B, H, hd)


def fused_decode_layer_reference(
    x: torch.Tensor, layer, k_pools: torch.Tensor, v_pools: torch.Tensor,
    layer_idx: int, block_tables: torch.Tensor, lengths: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, *, eps: float, n_heads: int,
    n_kv_heads: int, soft_cap: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K7 (same arguments, same rounding points)."""
    q, k_new, v_new = layer_qkv_reference(
        x, layer, sin, cos, eps=eps, n_heads=n_heads, n_kv_heads=n_kv_heads)
    ao = _decode_attention_reference(
        q, k_new, v_new, k_pools, v_pools, int(layer_idx), block_tables,
        lengths, x.dtype, soft_cap, k_scales, v_scales)
    x_out = layer_mlp_reference(x, ao, layer, eps=eps, n_heads=n_heads)
    return x_out, k_new, v_new


# --------------------------------------------------------------------------
# CUDA launch (shared by K7 and K8)
# --------------------------------------------------------------------------

class _Seg(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("cols", ctypes.c_int), ("period", ctypes.c_int)]


class _Proj(ctypes.Structure):
    _fields_ = [("seg", _Seg * 3)] + [(n, ctypes.c_int) for n in (
        "nseg", "wtype", "cols", "splits", "route", "nw", "nc", "kps",
        "stages")]


_INTS = ("rows", "D", "H", "KVH", "hd", "M", "act_type", "ln_type",
         "pool_type", "L", "P", "page", "maxp", "layer", "R", "tq",
         "attn_cluster", "attn_slots")
_PTRS = ("x", "ln_a", "ln_m", "sin", "cos")
_PTRS2 = ("k_pools", "v_pools", "k_scales", "v_scales", "block_tables",
          "lengths", "row_slot", "row_start", "row_len", "row_off", "xn",
          "part", "qkv_buf", "ao", "h", "act", "x_out", "k_new", "v_new",
          "counters", "stream")


class LayerArgs(ctypes.Structure):
    """Mirror of ``rtt::fused::LayerArgs`` (csrc/fused_layer.cuh)."""
    _fields_ = ([(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in ("scale", "soft_cap", "eps")]
                + [(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, _Proj) for n in ("qkv", "wo", "gateup", "down")]
                + [(n, ctypes.c_void_p) for n in _PTRS2])


def _segment(name: str, leaf, K: int, rows_fold: Optional[int] = None):
    """(weight [K, cols] in place, f32 scale or None, scale period) of one
    leaf, without a copy; raises on what the kernel does not take."""
    if _qdict(leaf):
        w, s = leaf["q"], leaf["scale"]
    else:
        w, s = leaf, None
    if not w.is_contiguous() or (s is not None and not s.is_contiguous()):
        raise ValueError(f"{name}: weights and scales must be contiguous")
    cols = w.numel() // K
    if w.numel() != K * cols or (rows_fold is None and w.shape[0] != K):
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not contract "
                         f"over {K}")
    if w.dtype not in _TYPE_CODE or cols % 4 \
            or w.data_ptr() % (4 * w.element_size()):
        raise ValueError(f"{name}: weight must be f32, bf16 or int8 with "
                         "a multiple of 4 columns, aligned to 4 elements")
    period = cols
    if s is not None:
        period = s.numel()
        if s.dtype != torch.float32 or cols % period:
            raise ValueError(f"{name}: scale must be f32 with a per-column "
                             f"(or per-head-dim) layout, got {s.dtype} "
                             f"{tuple(s.shape)} for {cols} columns")
    return w, s, cols, period


def _proj(name: str, leaves, K: int, rows: int, dt: torch.dtype, device,
          rows_fold: Optional[int] = None) -> Tuple[_Proj, int]:
    """One projection's segments and route, and the floats its partial
    sums need (split-K on the CUDA cores, shared tiles on the DECODE
    route; none on the WGMMA route)."""
    segs = [_segment(name, leaf, K, rows_fold) for leaf in leaves]
    if any(t is not None and t.device != device
           for w, s, *_ in segs for t in (w, s)):
        raise ValueError(f"{name}: weights must be on {device}")
    if len({w.dtype for w, *_ in segs}) != 1 \
            or len({s is None for _w, s, *_ in segs}) != 1:
        raise ValueError(f"{name}: mixed int8 and plain (or mixed dtype) "
                         "leaves; quantise or fuse them all "
                         "(models/quant.py)")
    pj = _Proj()
    for i, (w, s, cols, period) in enumerate(segs):
        pj.seg[i].w = w.data_ptr()
        pj.seg[i].scale = s.data_ptr() if s is not None else None
        pj.seg[i].cols = cols
        pj.seg[i].period = period
    pj.nseg = len(segs)
    pj.wtype = _TYPE_CODE[segs[0][0].dtype]
    pj.cols = sum(seg[2] for seg in segs)
    sms = _sm_count(device.index or 0)
    # A decode-width call over int8 weights streams them through the
    # persistent DECODE route: 128-column int8 boxes that never straddle a
    # segment, 16-byte aligned rows.
    if dt == torch.bfloat16 and rows <= DECODE_MAX_ROWS and K % 64 == 0 \
            and pj.cols % 256 == 0 and segs[0][0].dtype == torch.int8 \
            and all(w.data_ptr() % 16 == 0 and cols % 128 == 0
                    for w, _s, cols, _p in segs):
        plan = decode_plan(rows, K, pj.cols, sms)
        pj.route = _DECODE
        pj.nw, pj.nc = plan["nt"], 1
        pj.splits, pj.stages = plan["grid"], plan["stages"]
        return pj, plan["part_floats"]
    # bf16 activations and int8 or bf16 weights take wgmma over TMA tiles:
    # 64-column weight boxes that never straddle a segment, 16-byte
    # aligned rows.
    if dt == torch.bfloat16 and K % 8 == 0 and pj.cols % 128 == 0 \
            and segs[0][0].dtype in (torch.bfloat16, torch.int8) \
            and all(w.data_ptr() % 16 == 0 and cols % 64 == 0
                    for w, _s, cols, _p in segs):
        plan = wgmma_plan(rows, K, pj.cols, segs[0][0].element_size(), sms)
        pj.route = _WGMMA
        for key in ("nw", "nc", "splits", "kps", "stages"):
            setattr(pj, key, plan[key])
        return pj, 0
    pj.route = _CUDA_CORES
    tile_rows, tile_cols = _FMA_TILE
    # Split K until about two CTAs per SM are in flight.
    ctas = -(-rows // tile_rows) * -(-pj.cols // tile_cols)
    want = -(-2 * sms // ctas)
    pj.splits = max(1, min(want, K // _MIN_K_PER_SPLIT))
    return pj, pj.splits * rows * pj.cols


def launch_fused_layer(name: str, entry: str, x: torch.Tensor, layer,
                       k_pools: torch.Tensor, v_pools: torch.Tensor,
                       layer_idx: int, sin: torch.Tensor, cos: torch.Tensor,
                       *, eps: float, n_heads: int, n_kv_heads: int,
                       soft_cap: Optional[float],
                       k_scales: Optional[torch.Tensor],
                       v_scales: Optional[torch.Tensor],
                       block_tables: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       rows_desc: Optional[Tuple[torch.Tensor, ...]] = None,
                       tq: int = 0,
                       attn_smem: int = 0,
                       attn_plan: Tuple[int, int] = (0, 0)
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the operands of K7 or K8, lay out one workspace, and call
    the C entry ``entry`` of ``csrc/<name>.cu`` once on the current stream
    (no host sync, no host-made tensor: capturable).  ``attn_plan`` is
    K8's Hopper attention (cluster size, q-tile slots; 0: the CUDA-core
    kernel)."""
    rows, D = x.shape
    H, KVH = n_heads, n_kv_heads
    L, KVH_p, P, page, hd = k_pools.shape
    quantized = k_scales is not None
    _check_cuda(name, x=x, k_pools=k_pools, v_pools=v_pools,
                block_tables=block_tables, sin=sin, cos=cos)
    if quantized:
        _check_cuda(name, k_scales=k_scales, v_scales=v_scales)
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16) or k_pools.dtype != (
            torch.int8 if quantized else dt) or v_pools.dtype != k_pools.dtype:
        raise ValueError(f"{name}: x must be f32 or bf16 and the pools of "
                         "its dtype (int8 with scales), got "
                         f"{dt}, {k_pools.dtype}, {v_pools.dtype}")
    if D % H or H % KVH or KVH_p != KVH or hd != D // H or hd % 16 \
            or v_pools.shape != k_pools.shape \
            or sin.shape != (rows, hd // 2) or cos.shape != sin.shape \
            or sin.dtype != torch.float32 or cos.dtype != torch.float32 \
            or not 0 <= layer_idx < L:
        raise ValueError(
            f"{name}: bad shapes x {tuple(x.shape)}, heads {H}/{KVH}, pools "
            f"{tuple(k_pools.shape)}, sin/cos {tuple(sin.shape)} "
            f"{sin.dtype}, layer {layer_idx} (head_dim a multiple of 16)")
    if block_tables.dtype != torch.int32:
        raise ValueError(f"{name}: block_tables must be int32")
    if attn_smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: page {page} x head_dim {hd} needs "
                         f"{attn_smem} B of shared memory, over the H100's "
                         "227 KB")
    attn, mlp = layer["attn"], layer["mlp"]
    ln_a, ln_m = layer["ln_attn"], layer["ln_mlp"]
    for key, ln in (("ln_attn", ln_a), ("ln_mlp", ln_m)):
        if ln.shape != (D,) or ln.dtype not in (torch.float32,
                                                torch.bfloat16) \
                or ln.dtype != ln_a.dtype:
            raise ValueError(f"{name}: {key} must be [D] f32 or bf16")
    _check_cuda(name, ln_attn=ln_a, ln_mlp=ln_m)
    M = _mlp_dim(layer)
    dev = x.device
    qkv_leaves = ([attn["wqkv"]] if "wqkv" in attn
                  else [attn["wq"], attn["wk"], attn["wv"]])
    gu_leaves = ([mlp["w_gateup"]] if "w_gateup" in mlp
                 else [mlp["w_gate"], mlp["w_up"]])
    p_qkv, n1 = _proj(name + " qkv", qkv_leaves, D, rows, dt, dev)
    p_wo, n2 = _proj(name + " wo", [attn["wo"]], H * hd, rows, dt, dev,
                     rows_fold=H)
    p_gu, n3 = _proj(name + " gate/up", gu_leaves, D, rows, dt, dev)
    p_dn, n4 = _proj(name + " w_down", [mlp["w_down"]], M, rows, dt, dev)
    Cq = (H + 2 * KVH) * hd
    if p_qkv.cols != Cq or p_wo.cols != D or p_gu.cols != 2 * M \
            or p_dn.cols != D:
        raise ValueError(f"{name}: projection widths {p_qkv.cols}, "
                         f"{p_wo.cols}, {p_gu.cols}, {p_dn.cols} do not fit "
                         f"D={D} H={H} KVH={KVH} hd={hd} M={M}")
    x_out = torch.empty((rows, D), dtype=dt, device=dev)
    k_new = torch.empty((rows, KVH, hd), dtype=dt, device=dev)
    v_new = torch.empty((rows, KVH, hd), dtype=dt, device=dev)

    def pad(nbytes):  # 256-byte aligned buffers (TMA wants 16)
        return -(-nbytes // 256) * 256

    # The projections' activations in the activation dtype; qkv, h and
    # the partial sums in f32; the DECODE route's arrival count of each
    # column tile (csrc: decode_tiles; the chain's first norm zeroes them,
    # the last CTA to arrive at a tile resets its count).
    es = x.element_size()
    tiles = max((p.cols // 256 for p in (p_qkv, p_wo, p_gu, p_dn)
                 if p.route == _DECODE), default=0)
    sizes = {"xn": rows * D * es, "qkv_buf": rows * Cq * 4,
             "ao": rows * H * hd * es, "h": rows * D * 4,
             "act": rows * M * es, "part": 4 * max(n1, n2, n3, n4),
             "counters": 4 * tiles}
    ws = torch.empty(sum(pad(n) for n in sizes.values()), dtype=torch.uint8,
                     device=dev)
    a = LayerArgs()
    at = ws.data_ptr()
    for key, n in sizes.items():
        setattr(a, key, at)
        at += pad(n)
    a.rows, a.D, a.H, a.KVH, a.hd, a.M = rows, D, H, KVH, hd, M
    a.act_type = _TYPE_CODE[dt]
    a.ln_type = _TYPE_CODE[ln_a.dtype]
    a.pool_type = _TYPE_CODE[k_pools.dtype]
    a.L, a.P, a.page, a.maxp = L, P, page, block_tables.shape[1]
    a.layer = int(layer_idx)
    a.tq = tq
    a.attn_cluster, a.attn_slots = attn_plan
    a.scale = hd ** -0.5
    a.soft_cap = float(soft_cap) if soft_cap is not None else 0.0
    a.eps = float(eps)
    a.x, a.ln_a, a.ln_m = x.data_ptr(), ln_a.data_ptr(), ln_m.data_ptr()
    a.sin, a.cos = sin.data_ptr(), cos.data_ptr()
    a.qkv, a.wo, a.gateup, a.down = p_qkv, p_wo, p_gu, p_dn
    a.k_pools, a.v_pools = k_pools.data_ptr(), v_pools.data_ptr()
    if quantized:
        a.k_scales, a.v_scales = k_scales.data_ptr(), v_scales.data_ptr()
    a.block_tables = block_tables.data_ptr()
    if lengths is not None:
        a.lengths = lengths.data_ptr()
    if rows_desc is not None:
        a.R = rows_desc[0].shape[0]
        (a.row_slot, a.row_start, a.row_len,
         a.row_off) = (t.data_ptr() for t in rows_desc)
    a.x_out, a.k_new, a.v_new = (x_out.data_ptr(), k_new.data_ptr(),
                                 v_new.data_ptr())
    a.stream = _stream_ptr(x)
    fn = getattr(_build.library(name), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(LayerArgs)]
    # ws may be freed on return: the caching allocator hands its block
    # out again only to later work on this stream.
    _build.check(fn(ctypes.byref(a)), name)
    return x_out, k_new, v_new


def fused_decode_layer(
    x: torch.Tensor, layer, k_pools: torch.Tensor, v_pools: torch.Tensor,
    layer_idx: int, block_tables: torch.Tensor, lengths: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, *, eps: float, n_heads: int,
    n_kv_heads: int, soft_cap: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused decode layer: x [B, D] residual stream in (f32 or
    bf16, the dot dtype), pools [L, KVH, P, page, hd] read-only, layer
    ``layer_idx`` (a Python int) → (x_out [B, D], k_new [B, KVH, hd],
    v_new [B, KVH, hd]).  ``layer`` is one layer's parameter subtree:
    int8 ``{"q", "scale"}`` leaves or plain weights, fused
    (wqkv/w_gateup) or separate projections.  sin/cos [B, hd//2] f32 from
    rope_table; block_tables [B, maxp] and lengths [B] int32.  int8
    pools take ``k_scales``/``v_scales`` [L, P, KVH, 1] f32.

    CUDA tensors launch kernel K7 (csrc/fused_decode.cu; on int8 pools
    counted in ``launches_int8`` too); CPU tensors run the plain
    version."""
    quantized = _check_scales("fused_decode_layer", k_pools, v_pools,
                              k_scales, v_scales)
    if not x.is_cuda:
        return fused_decode_layer_reference(
            x, layer, k_pools, v_pools, layer_idx, block_tables, lengths,
            sin, cos, eps=eps, n_heads=n_heads, n_kv_heads=n_kv_heads,
            soft_cap=soft_cap, k_scales=k_scales, v_scales=v_scales)
    B = x.shape[0]
    _check_cuda("fused_decode_layer", lengths=lengths)
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or block_tables.shape[0] != B:
        raise ValueError("fused_decode_layer: lengths [B] and block_tables "
                         "[B, maxp] must be int32")
    _, _, _, page, hd = k_pools.shape
    qpg = n_heads // n_kv_heads
    smem = 4 * (3 * qpg * hd + page * (2 * hd + 4) + qpg * page + 6 * qpg)
    out = launch_fused_layer(
        "fused_decode", "rtt_fused_decode_layer", x, layer, k_pools, v_pools,
        int(layer_idx), sin, cos, eps=eps, n_heads=n_heads,
        n_kv_heads=n_kv_heads, soft_cap=soft_cap,
        k_scales=k_scales if quantized else None,
        v_scales=v_scales if quantized else None,
        block_tables=block_tables, lengths=lengths, attn_smem=smem)
    fused_decode_layer.launches += 1
    if quantized:
        fused_decode_layer.launches_int8 += 1
    return out


fused_decode_layer.launches = 0
fused_decode_layer.launches_int8 = 0
