"""Parameter and KV-cache bridge between the JAX package and the port,
through numpy.

The port keeps the JAX package's parameter tree as it is — the same
nesting, key names and layouts (``wq [L,d,H,hd]``, ``lm_head [d,V]``,
...) — so crossing is a pure copy with no transposes.  The caller turns
JAX arrays into numpy (``jax.tree.map(np.asarray, params)``) outside
this package: the bridge never imports jax.

A LoRA adapter crosses through ``adapter_from_jax``: the factor tree
(``{target: {"a", "b"}}``) or the flat vector of ``flatten_adapter``, as
numpy, becomes the port's tensors, which the port's adapter pool loads
as they are (one ``lora_loader`` can serve both packages).

An optimizer state (``train.AdamW``'s ``{"count", "mu", "nu"}``) comes
back to the host through ``opt_state_to_numpy``, so its moments can be
held against optax's.

A paged cache crosses the same way (``paged_cache_from_jax`` /
``paged_cache_to_numpy``): the port keeps the pools [L, KVH, P+1, page,
D] and, for int8 pools, the page-major scales [L, P+1, KVH, 1].

f32 and int8 leaves cross exactly.  bf16 leaves (numpy's ``bfloat16`` extension
dtype, as ``np.asarray`` returns them) cross bit-exactly through a
16-bit view.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


def _leaf_to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict of numpy arrays → the same nesting of tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return _leaf_to_torch(tree, dev)


def params_to_numpy(tree: Any, bf16_dtype: Optional[Any] = None) -> Any:
    """Inverse of ``params_from_jax``: tensors → numpy on the host.

    A bf16 tensor comes back bit-exactly as ``bf16_dtype`` (pass
    ``jnp.bfloat16`` or ``ml_dtypes.bfloat16``) through a 16-bit view;
    without it, as float32, which holds every bf16 value exactly."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v, bf16_dtype) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        if bf16_dtype is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(np.dtype(bf16_dtype))
    return t.numpy()


def adapter_from_jax(adapter: Any, device: DeviceLike = None) -> Any:
    """A JAX LoRA adapter as numpy (the factor tree ``{target: {"a": [L,
    d_in, r], "b": [L, r, d_out]}}`` or the flat f32 vector of
    ``segmented_lora.flatten_adapter``) → the same layout as f32 tensors
    on ``device`` (default: the card)."""
    dev = resolve_device(device)
    if isinstance(adapter, dict):
        return {k: adapter_from_jax(v, dev) for k, v in adapter.items()}
    a = np.asarray(adapter, np.float32)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(dev)


_CACHE_KEYS = ("k", "v", "k_scale", "v_scale")


def paged_cache_from_jax(cache: Any, device: DeviceLike = None) -> Any:
    """A JAX paged cache as numpy arrays (``k``, ``v`` and, for int8
    pools, ``k_scale``, ``v_scale``) → the port's cache dict on
    ``device``: new tensors, same layouts, so both sides can start from
    one pool."""
    unknown = set(cache) - set(_CACHE_KEYS)
    if unknown or not {"k", "v"} <= set(cache) \
            or ("k_scale" in cache) != ("v_scale" in cache):
        raise ValueError(f"not a paged cache: keys {sorted(cache)}")
    dev = resolve_device(device)
    return {key: _leaf_to_torch(cache[key], dev)
            for key in _CACHE_KEYS if key in cache}


def paged_cache_to_numpy(cache: Any, bf16_dtype: Optional[Any] = None) -> Any:
    """Inverse of ``paged_cache_from_jax``: the port's cache dict →
    numpy arrays on the host (bf16 pools as ``params_to_numpy`` returns
    them)."""
    return params_to_numpy(dict(cache), bf16_dtype)


def opt_state_to_numpy(opt_state: Any, bf16_dtype: Optional[Any] = None
                       ) -> Any:
    """``train.AdamW``'s state → ``{"count": int, "mu": ..., "nu": ...}``
    with numpy moments (bf16 ones as ``params_to_numpy`` returns them)."""
    return {"count": int(opt_state["count"]),
            "mu": params_to_numpy(opt_state["mu"], bf16_dtype),
            "nu": params_to_numpy(opt_state["nu"], bf16_dtype)}
