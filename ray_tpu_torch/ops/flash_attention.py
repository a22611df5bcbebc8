"""Flash attention, forward and backward (port of
``ray_tpu/ops/flash_attention.py``).

Same layout contract as the JAX ``flash_attention``: q [B, S, H, D],
k/v [B, S, KVH, D] with H a multiple of KVH → [B, S, H, D].  On CUDA
tensors the forward is kernel K9f (csrc/flash_fwd.cu): blockwise
online softmax, causal tiles above the diagonal skipped, GQA by
kv-head index; it also returns the per-row log-sum-exp that the
backward reads.  The backward is kernels K10 (dq) and K11 (dk, dv,
summed over each kv head's group of q heads) in csrc/flash_bwd.cu,
both recomputing p from that log-sum-exp, so nothing S × S reaches
device memory.  ``flash_attention`` goes through ``_Flash``, a
``torch.autograd.Function`` pairing K9f with K10 + K11, as the JAX
package pairs its kernels in a ``custom_vjp``.  Tensors on the CPU run
the plain versions of all three.  In bf16 at D 64 and 128 (every real
configuration) K9f, K10 and K11 are Hopper kernels (wgmma on TMA-fed
shared memory, csrc/hopper.cuh); f32 and D 16 or 32 run mma.sync (bf16)
or FMA (f32) tiles.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tpu_torch.ops import _build

# Eligibility blocks of the JAX dispatch (ops/attention.py): the port
# keeps the same rule; the CUDA kernel tiles by 64 internally.
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_KV = 512
NEG_INF = -1e30
_TILE = 64
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _expand(k: torch.Tensor, H: int) -> torch.Tensor:
    """k/v [B,S,KVH,D] → [B,S,H,D]: q head h reads kv head h // (H/KVH)."""
    group = H // k.shape[2]
    return k if group == 1 else k.repeat_interleave(group, dim=2)


def _masked_scores(q: torch.Tensor, kx: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """q·kᵀ · scale [B,H,S,S] in f32, masked scores at NEG_INF as in the
    Pallas bodies; kx already expanded to q's heads."""
    S, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) * (D ** -0.5)
    if causal:
        qi = torch.arange(S, device=q.device)[:, None]
        ki = torch.arange(S, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
    return s


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9f: dense f32 softmax attention → (o [B,S,H,D]
    in q.dtype, lse [B,H,S] f32).  p is rounded to v's dtype before p·v,
    here at the final lse; the Pallas body and the kernel round
    exp(s − m) at their running max m before dividing by l, so in bf16
    the two differ by about a bf16 ulp of p."""
    H = q.shape[2]
    s = _masked_scores(q, _expand(k, H), causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, _expand(v, H).float())
    return o.to(q.dtype), lse


def _check_cuda(what: str, q: torch.Tensor, k: torch.Tensor,
                tensors) -> None:
    """The kernels' contract: every tensor on q's card, contiguous, 16-byte
    aligned and in q's dtype (f32 or bf16); S a multiple of 64 and D in
    {16, 32, 64, 128}; H a multiple of KVH."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"want {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous "
                             "and 16-byte aligned")
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} must share q's dtype")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {q.dtype} (want f32/bf16)")
    if (k.shape != (B, S, KVH, D) or H % KVH or S % _TILE
            or D not in _HEAD_DIMS):
        raise ValueError(
            f"{what}: unsupported shapes q {tuple(q.shape)}, k "
            f"{tuple(k.shape)} (S % {_TILE} == 0, D in {_HEAD_DIMS})")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,S,H,D], k/v [B,S,KVH,D] → (o [B,S,H,D], lse [B,H,S] f32).

    CUDA tensors launch kernel K9f (S a multiple of 64, D in
    {16, 32, 64, 128}, f32 or bf16, contiguous); CPU tensors run the
    plain version."""
    if not q.is_cuda:
        return flash_forward_plain(q, k, v, causal)
    _check_cuda("flash_forward", q, k, (("q", q), ("k", k), ("v", v)))
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if v.shape != k.shape:
        raise ValueError("flash_forward: v must have k's shape")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return o, lse
    lib = _build.library("flash_fwd")
    fn = lib.rtt_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), _DTYPE_CODE[q.dtype], B, S, H, KVH, D,
             D ** -0.5, int(bool(causal)),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_forward")
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


# --- backward ---------------------------------------------------------------

def _probs(q, kx, lse, causal):
    """p = exp(s − lse) [B,H,S,S] in f32, recomputed from the forward's
    lse."""
    return torch.exp(_masked_scores(q, kx, causal) - lse[..., None])


def flash_backward_dq_plain(q, k, v, do, lse, delta, causal: bool = True
                            ) -> torch.Tensor:
    """Plain version of K10 (the Pallas ``_dq_kernel``): dq = scale · ds·k
    with ds = p (dp − δ), ds rounded to k's dtype before the product.
    q/do [B,S,H,D], k/v [B,S,KVH,D], lse/δ [B,H,S] f32 → dq in q.dtype."""
    H, D = q.shape[2], q.shape[3]
    kx, vx = _expand(k, H), _expand(v, H)
    p = _probs(q, kx, lse, causal)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vx.float())
    ds = (p * (dp - delta[..., None])).to(k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kx.float()) * (D ** -0.5)
    return dq.to(q.dtype)


def flash_backward_dkv_plain(q, k, v, do, lse, delta, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K11 (the Pallas ``_dkv_kernel`` and the group sum
    of ``_flash_bwd_rule``): dv = pᵀ·do with p rounded to do's dtype,
    dk = scale · dsᵀ·q with ds rounded to q's dtype, each summed over
    the q heads of its kv head → (dk, dv) [B,S,KVH,D] in k's dtype.  The
    group sum is taken in f32 before the one rounding, as K11 takes it;
    the TPU path rounds each head's dk/dv first."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    kx, vx = _expand(k, H), _expand(v, H)
    p = _probs(q, kx, lse, causal)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vx.float())
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * (D ** -0.5)
    # q head h belongs to kv head h // (H / KVH), as in _flash_bwd_rule.
    group = lambda x: x.reshape(B, S, KVH, H // KVH, D).sum(3)  # noqa: E731
    return group(dk).to(k.dtype), group(dv).to(v.dtype)


def _bwd_fn(name: str):
    fn = getattr(_build.library("flash_bwd"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * (8 if name.endswith("dkv") else 7)
                   + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _bwd_args(q, k, v, do, lse, delta):
    _check_cuda("flash_backward", q, k,
                (("q", q), ("k", k), ("v", v), ("do", do)))
    B, S, H, D = q.shape
    if v.shape != k.shape or do.shape != q.shape:
        raise ValueError("flash_backward: v must have k's shape, do q's")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (B, H, S)
                or not t.is_contiguous() or t.device != q.device
                or t.data_ptr() % 16):
            raise ValueError(f"flash_backward: {name} must be f32 "
                             f"[B, H, S] on {q.device}, contiguous and "
                             "16-byte aligned")
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr()]


def flash_backward_dq(q, k, v, do, lse, delta, causal: bool = True
                      ) -> torch.Tensor:
    """dq [B,S,H,D]: kernel K10 for CUDA tensors, the plain version on
    the CPU."""
    if not q.is_cuda:
        return flash_backward_dq_plain(q, k, v, do, lse, delta, causal)
    ptrs = _bwd_args(q, k, v, do, lse, delta)
    B, S, H, D = q.shape
    dq = torch.empty_like(q)
    if B == 0 or S == 0:
        return dq
    err = _bwd_fn("rtt_flash_bwd_dq")(
        *ptrs, dq.data_ptr(), _DTYPE_CODE[q.dtype], B, S, H, k.shape[2], D,
        D ** -0.5, int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_backward_dq")
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


def flash_backward_dkv(q, k, v, do, lse, delta, causal: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,S,KVH,D] in k's dtype, summed over each kv head's q
    heads: kernel K11 for CUDA tensors (the group sum in f32 inside the
    kernel), the plain version on the CPU."""
    if not q.is_cuda:
        return flash_backward_dkv_plain(q, k, v, do, lse, delta, causal)
    ptrs = _bwd_args(q, k, v, do, lse, delta)
    B, S, H, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if B == 0 or S == 0:
        return dk, dv
    err = _bwd_fn("rtt_flash_bwd_dkv")(
        *ptrs, dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], B, S, H,
        k.shape[2], D, D ** -0.5, int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dkv.launches = 0


def flash_backward_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """δ = Σ_D o·do [B,H,S] in f32 (the JAX backward's ``delta``), from
    o/do [B,S,H,D].  An elementwise product and a sum, f32 on every
    device (a contraction could go to TF32 matmul units)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward(q, k, v, o, lse, do, causal: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``flash_forward``'s o: (dq [B,S,H,D], dk, dv
    [B,S,KVH,D]), already summed over the GQA group as
    ``_flash_bwd_rule`` returns them: δ, then K10 and K11 on the card,
    or their plain versions on the CPU."""
    do = do.contiguous()  # autograd may hand over a strided gradient
    delta = flash_backward_delta(o, do)
    dq = flash_backward_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """K9f forward, K10 + K11 backward (the JAX ``custom_vjp``): saves
    (q, k, v, o, lse) and recomputes p in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Blockwise attention. q [B,S,H,D], k/v [B,S,KVH,D] → [B,S,H,D];
    differentiable through K10 + K11.

    The JAX rule sends any causal S from 256 to 511 to its kernel (one
    block of S); the CUDA kernels tile S by 64.  On the card a causal S
    off the tile is zero-padded to the next multiple of 64 and the
    output cut back: under the causal mask no real query sees a padded
    key, and the padded queries' zero gradient adds exact zeros to the
    real keys' dk/dv, so the real rows are what an S-row kernel would
    give."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"n_heads {q.shape[2]} not divisible by kv heads "
                         f"{k.shape[2]}")
    S = q.shape[1]
    pad = (-S) % _TILE
    if q.is_cuda and causal and pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
        return _Flash.apply(q, k, v, causal)[:, :S]
    return _Flash.apply(q, k, v, causal)
