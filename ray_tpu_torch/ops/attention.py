"""Attention ops (port of ``ray_tpu/ops/attention.py``).

The einsum path below is the portable reference, differentiable by
autograd; the flash kernels (``ops/flash_attention.py``: K9f forward,
K10 + K11 backward through one ``torch.autograd.Function``) take over
for CUDA tensors under the same eligibility rule as the JAX package
(causal, unpacked, no soft cap, no decode offset, block-divisible
S >= 256).  ``decode_attention`` (one step against a dense
[B, S_max, KVH, D] cache) is plain PyTorch, as the JAX package's is
plain ``jnp``.

Conventions: q [B, S, H, D], k/v [B, S, KVH, D] with H a multiple of
KVH (grouped-query attention).
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops import flash_attention as _fa


def _gqa_expand(k: torch.Tensor, groups: int) -> torch.Tensor:
    return k if groups == 1 else k.repeat_interleave(groups, dim=2)


def _on_card(q: torch.Tensor) -> bool:
    """The JAX package's ``_on_tpu``: the flash kernels run on the card."""
    return q.is_cuda


def _flash_eligible(q, k, causal, segment_ids, logits_soft_cap) -> bool:
    B, S, H, D = q.shape
    # must mirror flash_attention's own validation: blocks clamp to S
    bq = min(_fa.DEFAULT_BLOCK_Q, S)
    bk = min(_fa.DEFAULT_BLOCK_KV, S)
    return (
        causal
        and segment_ids is None
        and logits_soft_cap is None
        and k.shape[1] == S  # no decode-offset (k longer than q) support
        and S % bq == 0
        and S % bk == 0
        and S >= 256
        and H % k.shape[2] == 0
        and _on_card(q)
    )


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention with GQA and optional packing.

    Dispatches to the flash kernel for CUDA tensors when eligible;
    otherwise the einsum path, computed in float32 regardless of input
    dtype."""
    if _flash_eligible(q, k, causal, segment_ids, logits_soft_cap):
        return _fa.flash_attention(q, k, v, causal=True)
    orig_dtype = q.dtype
    n_heads, head_dim = q.shape[2], q.shape[3]
    groups = n_heads // k.shape[2]
    k = _gqa_expand(k, groups)
    v = _gqa_expand(v, groups)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * head_dim ** -0.5
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    q_len, k_len = logits.shape[-2], logits.shape[-1]
    mask = None
    if causal:
        # offset supports decode: q positions are the last q_len of k_len
        qi = torch.arange(q_len, device=q.device)[:, None] + (k_len - q_len)
        ki = torch.arange(k_len, device=q.device)[None, :]
        mask = (qi >= ki)[None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(orig_dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     logits_soft_cap: Optional[float] = None
                     ) -> torch.Tensor:
    """Single-step attention against a (possibly longer) KV cache.

    q [B, Q, H, D]; caches [B, S_max, KVH, D]; cache_len [B] valid
    lengths (the new token's k/v already written at cache_len - 1).
    Logits in float32; positions at or past cache_len are masked with
    -1e30, not -inf, so an empty slot gets uniform weights and no NaN.
    Each kv head serves its group of H / KVH query heads in place (the
    JAX package expands k/v to H heads first: the same products, without
    the [B, S_max, H, D] float32 copies)."""
    orig_dtype = q.dtype
    B, Q, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(B, Q, KVH, H // KVH, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float()) \
        * D ** -0.5
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    valid = torch.arange(S, device=q.device)[None, :] < cache_len[:, None]
    logits = logits.masked_fill(~valid[:, None, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache.float())
    return out.reshape(B, Q, H, D).to(orig_dtype)
