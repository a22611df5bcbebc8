"""The Mamba-2 SSD chunk scan (port of ``ray_tpu/ops/mamba_ssd.py``).

Same contract as the JAX ``ssd_pallas``, a drop-in for
``models/mamba2.ssd_chunked``: x [B, S, H, P] (already scaled by dt),
log_a [B, S, H] <= 0, Bm/Cm [B, S, N] shared by the heads → y
[B, S, H, P] float32, with h[t] = exp(log_a[t]) h[t-1] + B[t] x[t] and
y[t] = C[t] · h[t], in f32 state math.

On CUDA tensors the forward is kernel K12 (csrc/mamba_ssd.cu): one CTA
per (batch, head, slice of P) walks the sequence in 32-position blocks
with its [N, P_tile] state in registers, the block's products on the
tensor cores in split precision (3xTF32; ``ssd_plan`` sizes the grid).
``ssd_pallas_plain`` is the Pallas kernel's own
recurrence in plain PyTorch; CPU tensors run it.  ``ssd_pallas`` is the
differentiable entry, a ``torch.autograd.Function`` whose backward
recomputes through the port's ``ssd_chunked`` at the given chunk, as
the JAX ``custom_vjp`` does: no backward kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.paged_attention import _sm_count

_BC_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Positions per block of K12's sequence walk (csrc/mamba_ssd.cu: T).
BLOCK_T = 32
# State rows a CTA can hold: N padded to one of these (csrc: NP = 32 MT).
# A larger N is walked in slices of the last (``ssd_forward``).
_STATE_ROWS = (32, 64, 128, 256)
_SMEM_LIMIT = 227 * 1024


def resolve_chunk(S: int, chunk: int) -> int:
    """The Pallas kernel's chunk rule (mamba_ssd.py:101-102): 256 when the
    chunk is smaller and the sequence allows it.  The output does not
    depend on the chunk except through rounding."""
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    return 256 if chunk < 256 and S % 256 == 0 else chunk


def ssd_pallas_plain(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor,
                     Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Plain version of K12: ``_ssd_kernel``'s recurrence at the resolved
    chunk.  The chunks are walked in order with an f32 state [B, H, N,
    P]; within a chunk the cumulative log-decay is a product with the
    lower-triangular matrix, the masked decay matrix multiplies C·Bᵀ,
    and the state decays by the chunk's total.  No gradient: the
    autograd Function recomputes through ``ssd_chunked``."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    c = resolve_chunk(S, chunk)
    f32 = torch.float32
    dev = x.device
    ii = torch.arange(c, device=dev)
    lower = ii[:, None] >= ii[None, :]
    tri = lower.to(f32)
    state = torch.zeros((B, H, N, P), dtype=f32, device=dev)
    out = torch.empty((B, S, H, P), dtype=f32, device=dev)
    for z in range(S // c):
        sl = slice(z * c, (z + 1) * c)
        Cc, Bc = Cm[:, sl].to(f32), Bm[:, sl].to(f32)       # [B, c, N]
        xc = x[:, sl].to(f32)                                # [B, c, H, P]
        scores = Cc @ Bc.transpose(1, 2)                     # [B, c, c]
        cum = torch.einsum("ij,bjh->bih", tri, log_a[:, sl].to(f32))
        total = cum[:, -1]                                   # [B, H]
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # [B, i, j, H]
        # Masked before the exp: above the diagonal diff > 0 overflows.
        L = torch.exp(torch.where(lower[None, :, :, None], diff,
                                  torch.full_like(diff, -torch.inf)))
        w = scores[..., None] * L
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bin,bhnp->bihp", Cc, state)
        dte = torch.exp(total[:, None, :] - cum)             # [B, c, H]
        # (B ∘ exp(total − cum))ᵀ·x per head, as the kernel's state dot.
        bd = Bc[:, :, None, :] * dte[..., None]              # [B, c, H, N]
        state = torch.exp(total)[..., None, None] * state + torch.einsum(
            "bjhn,bjhp->bhnp", bd, xc)
        out[:, sl] = y
    return out


def _smem_bytes(np_: int, p_tile: int, bc_bytes: int) -> int:
    """Dynamic shared memory of K12's CTA (csrc/mamba_ssd.cu smem_bytes):
    x, B and C of two blocks, log_a of two blocks, the state copy and
    the block's decay matrix."""
    T = BLOCK_T
    return (4 * 2 * T * (p_tile + 4) + 2 * 2 * T * (np_ + 8) * bc_bytes
            + 4 * 2 * T + 4 * p_tile * (np_ + 8) + 4 * T * (T + 8))


@functools.lru_cache(maxsize=None)
def ssd_plan(B: int, H: int, P: int, N: int, bc_bytes: int,
             sms: int) -> dict:
    """K12's launch for N of at most 256 state rows (``ssd_forward``
    slices a larger N): ``p_tile`` state columns a CTA (32 where P allows it
    and the grid still fills the card, else 16), ``np`` state rows (N
    padded), the grid (P / p_tile, H, B), threads, shared memory, and how
    many CTAs fit on an SM by shared memory and by threads (``per_sm``)
    and so how many waves the grid takes (cached; read-only)."""
    np_ = next((n for n in _STATE_ROWS if n >= N), None)
    if np_ is None or N % 8 or P % 16:
        raise ValueError(f"ssd_forward: unsupported P={P} (a multiple of "
                         f"16) or N={N} (a multiple of 8; a launch takes "
                         f"at most {_STATE_ROWS[-1]})")
    p_tile = 32 if P % 32 == 0 and B * H * (P // 32) >= sms else 16
    smem = _smem_bytes(np_, p_tile, bc_bytes)
    threads = 8 * p_tile
    per_sm = min((_SMEM_LIMIT + 1024) // (smem + 1024), 2048 // threads, 32)
    ctas = (P // p_tile) * H * B
    return {"p_tile": p_tile, "np": np_, "grid": (P // p_tile, H, B),
            "ctas": ctas, "threads": threads, "smem": smem,
            "per_sm": per_sm, "waves": -(-ctas // (per_sm * sms))}


def _check_cuda(x, log_a, Bm, Cm):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    for name, t in (("x", x), ("log_a", log_a), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_forward: {name} is on {t.device}, "
                             f"want {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_forward: {name} must be 16-byte aligned")
    if x.dtype != torch.float32 or log_a.dtype != torch.float32:
        raise ValueError("ssd_forward: x and log_a must be float32, got "
                         f"{x.dtype}, {log_a.dtype}")
    if Bm.dtype not in _BC_CODE or Cm.dtype != Bm.dtype:
        raise ValueError("ssd_forward: Bm and Cm must share dtype f32 or "
                         f"bf16, got {Bm.dtype}, {Cm.dtype}")
    if (log_a.shape != (B, S, H) or Bm.shape != (B, S, N)
            or Cm.shape != Bm.shape):
        raise ValueError(
            f"ssd_forward: bad shapes x {tuple(x.shape)}, log_a "
            f"{tuple(log_a.shape)}, Bm {tuple(Bm.shape)}, Cm "
            f"{tuple(Cm.shape)}")


def ssd_forward(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """y [B, S, H, P] f32 of the SSD recurrence.  CUDA tensors launch
    kernel K12 (x, log_a f32; Bm, Cm f32 or bf16, made contiguous here
    when they are column slices; P a multiple of 16, N of 8); CPU
    tensors run ``ssd_pallas_plain``.  ``chunk`` is checked (S % chunk
    == 0) and resolved as the Pallas kernel resolves it; K12 walks the
    sequence in blocks of ``BLOCK_T`` positions whatever it is, which
    changes only the rounding.  N above 256 (more state rows than a CTA
    holds) takes one launch per slice of 256 rows, the slices' y summed
    in order: y is linear in the state rows (C·Bᵀ and C·state both sum
    over them)."""
    if not x.is_cuda:
        return ssd_pallas_plain(x, log_a, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    resolve_chunk(S, chunk)
    rows = _STATE_ROWS[-1]
    if N > rows and N % 8 == 0:
        y = ssd_forward(x, log_a, Bm[..., :rows], Cm[..., :rows], chunk)
        for n0 in range(rows, N, rows):
            y += ssd_forward(x, log_a, Bm[..., n0:n0 + rows],
                             Cm[..., n0:n0 + rows], chunk)
        return y
    x, log_a = x.contiguous(), log_a.contiguous()
    Bm, Cm = Bm.contiguous(), Cm.contiguous()
    _check_cuda(x, log_a, Bm, Cm)
    plan = ssd_plan(B, H, P, N, Bm.element_size(),
                    _sm_count(x.device.index or 0))
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    if B == 0 or S == 0 or H == 0:
        return y
    fn = _build.library("mamba_ssd").rtt_ssd_scan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    err = fn(x.data_ptr(), log_a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             y.data_ptr(), _BC_CODE[Bm.dtype], B, S, H, P, N,
             plan["p_tile"], plan["np"],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_forward")
    ssd_forward.launches += 1
    return y


ssd_forward.launches = 0


class _SSD(torch.autograd.Function):
    """K12 forward; the backward recomputes through ``ssd_chunked`` at the
    given chunk (the JAX ``_bwd``) and returns each cotangent in its
    input's dtype, as JAX's VJP does (Bm/Cm are bf16 in the model)."""

    @staticmethod
    def forward(ctx, x, log_a, Bm, Cm, chunk):
        ctx.save_for_backward(x, log_a, Bm, Cm)
        ctx.chunk = chunk
        return ssd_forward(x, log_a, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, g):
        from ray_tpu_torch.models.mamba2 import ssd_chunked

        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = ssd_chunked(*inputs, chunk=ctx.chunk)
            grads = torch.autograd.grad(y, inputs, g.float())
        return (*(gr.to(t.dtype) for gr, t in zip(grads, inputs)), None)


def ssd_pallas(x: torch.Tensor, log_a: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Drop-in for ``models/mamba2.ssd_chunked``: y [B, S, H, P] f32,
    differentiable (backward through ``ssd_chunked``)."""
    return _SSD.apply(x, log_a, Bm, Cm, chunk)

