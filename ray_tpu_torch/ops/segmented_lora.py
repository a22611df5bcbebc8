"""Segmented (multi-adapter) LoRA matmul for the ragged serving step (port
of ``ray_tpu/ops/segmented_lora.py``).

One unified ragged batch can carry rows of *different* fine-tuned
adapters: each packed token carries an index into the step's small
adapter gather set, and every LoRA-targeted projection adds
``y += (x @ A[idx]) @ B[idx] * scale`` with per-token factors gathered
from the paged adapter pool (``serve/adapter_pool.py``).

Index 0 of the gather set is the NULL adapter: its pages are the pool's
scratch page, all zeros and never written, so base-model rows
(``adapter_id == ""``) see an exact-zero delta, and ``x + 0.0`` is exact
in every IEEE dtype: mixed batches stay byte-identical to adapter-off
serving on those rows.

The products are gathered einsums ([T, d_in, r] and [T, r, d_out]
operand stacks per token), as in the JAX package: each token reads only
its own factors.  There is no Pallas kernel behind them there, so there
is no CUDA kernel here either.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Tuple

import numpy as np
import torch

# Projection targets, in flattening order.  "qkv" is one joint factor
# pair over the concatenated q/k/v output axis (the concatenation of
# quant.fuse_for_decode's wqkv), applied before RoPE.
TARGETS = ("qkv", "o", "gate", "up", "down")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Shape and scale every adapter of a pool shares: a fixed rank and
    target set make every adapter the same number of pool pages."""

    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def __post_init__(self):
        bad = [t for t in self.targets if t not in TARGETS]
        if bad:
            raise ValueError(f"unknown LoRA targets {bad!r} "
                             f"(want a subset of {TARGETS})")


def target_shapes(cfg: Any, lora: LoRAConfig) -> Dict[str, Tuple[int, int]]:
    """target -> (d_in, d_out) of the projection the factors bracket."""
    d, m = cfg.dim, cfg.mlp_dim
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "qkv": (d, (H + 2 * KVH) * hd),
        "o": (H * hd, d),
        "gate": (d, m),
        "up": (d, m),
        "down": (m, d),
    }
    return {t: shapes[t] for t in lora.targets}


def adapter_elems(cfg: Any, lora: LoRAConfig) -> int:
    """f32 element count of one flattened adapter (all layers)."""
    r = lora.rank
    per_layer = sum(din * r + r * dout
                    for din, dout in target_shapes(cfg, lora).values())
    return cfg.n_layers * per_layer


def init_adapter_params(generator: torch.Generator, cfg: Any,
                        lora: LoRAConfig) -> Dict[str, Any]:
    """Random adapter factors {target: {"a": [L, d_in, r], "b": [L, r,
    d_out]}} in f32 on the generator's device, drawn target by target, a
    then b.  Both factors are non-zero (unlike the training-time B = 0
    convention) so distinct adapters give distinct outputs: a serving
    test and benchmark artifact, not a fine-tuning initialiser.  The
    draws differ from the JAX package's (``jax.random``)."""
    L, r = cfg.n_layers, lora.rank
    dev = generator.device
    out: Dict[str, Any] = {}
    for t, (din, dout) in target_shapes(cfg, lora).items():
        a = torch.randn((L, din, r), generator=generator, device=dev)
        b = torch.randn((L, r, dout), generator=generator, device=dev)
        out[t] = {"a": a.mul_(din ** -0.5), "b": b.mul_(r ** -0.5)}
    return out


def default_adapter_loader(cfg: Any, lora: LoRAConfig):
    """adapter_id -> adapter factors, drawn on the CPU from a generator
    seeded with crc32(id): every process that loads one id gets the same
    factors.  Real deployments pass a checkpoint loader with the same
    signature."""

    def load(adapter_id: str) -> Dict[str, Any]:
        seed = zlib.crc32(adapter_id.encode("utf-8"))
        return init_adapter_params(torch.Generator().manual_seed(seed), cfg,
                                   lora)

    return load


def _host_f32(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def flatten_adapter(adapter: Dict[str, Any], cfg: Any,
                    lora: LoRAConfig) -> np.ndarray:
    """One C-order f32 vector [adapter_elems]: per target, A then B.
    Leaves may be tensors or numpy arrays."""
    parts = []
    for t, (din, dout) in target_shapes(cfg, lora).items():
        a = _host_f32(adapter[t]["a"])
        b = _host_f32(adapter[t]["b"])
        want_a = (cfg.n_layers, din, lora.rank)
        want_b = (cfg.n_layers, lora.rank, dout)
        if a.shape != want_a or b.shape != want_b:
            raise ValueError(
                f"adapter target {t!r}: got a{a.shape}/b{b.shape}, "
                f"want a{want_a}/b{want_b}")
        parts.append(a.ravel())
        parts.append(b.ravel())
    return np.concatenate(parts)


def gather_adapter_stacks(flat: torch.Tensor, cfg: Any,
                          lora: LoRAConfig) -> Dict[str, Any]:
    """Gathered pool rows [K, >= adapter_elems] as per-target stacks
    {target: {"a": [L, K, d_in, r], "b": [L, K, r, d_out]}}, layer axis
    first so the layer loop slices them beside the weights.  Views of
    ``flat``: nothing is copied here."""
    K = flat.shape[0]
    L, r = cfg.n_layers, lora.rank
    out: Dict[str, Any] = {}
    off = 0
    for t, (din, dout) in target_shapes(cfg, lora).items():
        na, nb = L * din * r, L * r * dout
        a = flat[:, off:off + na].reshape(K, L, din, r)
        b = flat[:, off + na:off + na + nb].reshape(K, L, r, dout)
        out[t] = {"a": a.movedim(1, 0), "b": b.movedim(1, 0)}
        off += na + nb
    return out


def gather_adapter_flat(pool: Any, page_table: torch.Tensor) -> torch.Tensor:
    """Each batch adapter's pages from the pool, laid out flat: [K,
    pages_per_adapter * page_elems] f32.  ``pool`` is the f32 page array
    [P+1, page_elems] or the int8 dict {"q": [P+1, page_elems] int8,
    "scale": [P+1, 1] f32} (a per-page absmax, models/quant.py); the
    scratch page gives exact zeros either way (q == 0)."""
    idx = page_table.long()
    if isinstance(pool, dict):
        pages = pool["q"][idx].float() * pool["scale"][idx]
    else:
        pages = pool[idx]
    return pages.reshape(page_table.shape[0], -1)


def segmented_lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         idx: torch.Tensor, scale: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """``(x @ A[idx]) @ B[idx] * scale`` per token, in ``dtype``.  x [T,
    d_in], a [K, d_in, r], b [K, r, d_out], idx [T] -> [T, d_out].  Null
    rows (idx -> scratch zeros) give exact 0.  The gathered factors live
    only for this call: at 8B the down projection's [T, d_in, r] stack is
    tens of MB."""
    i = idx.long()
    at = a.to(dtype)[i]                              # [T, d_in, r]
    bt = b.to(dtype)[i]                              # [T, r, d_out]
    h = torch.bmm(x.to(dtype)[:, None, :], at)       # [T, 1, r]
    out = torch.bmm(h, bt)[:, 0]                     # [T, d_out]
    # The scale rounded to dtype first, as jnp.asarray(scale, dtype).
    return out * float(torch.tensor(scale, dtype=dtype))
