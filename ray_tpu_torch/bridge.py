"""Parameter and KV-cache bridge between the JAX package and the port,
through numpy.

The port keeps the JAX package's parameter tree as it is — the same
nesting (dicts, and lists for RLlib's MLP layers), key names and layouts
(``wq [L,d,H,hd]``, ``lm_head [d,V]``,
...) — so crossing is a pure copy with no transposes.  The caller turns
JAX arrays into numpy (``jax.tree.map(np.asarray, params)``) outside
this package: the bridge never imports jax.

A rank's share of a MoE layer's experts (expert parallelism) crosses
through ``experts_from_jax``: the router whole, E/ep experts sliced.

A LoRA adapter crosses through ``adapter_from_jax``: the factor tree
(``{target: {"a", "b"}}``) or the flat vector of ``flatten_adapter``, as
numpy, becomes the port's tensors, which the port's adapter pool loads
as they are (one ``lora_loader`` can serve both packages).

An optimizer state (``train.AdamW``'s or ``train.adamw8bit``'s
``{"count", "mu", "nu"}``, the latter with an ``(int8 q, f32 scale)``
pair at each leaf) comes back to the host through
``opt_state_to_numpy``, so its moments can be held against optax's.  A
JAX chain state (optax's tuple of per-transform states, as numpy)
crosses into the port with ``opt_state_from_jax``, and a port state goes
back into such a chain with ``opt_state_to_jax``: the ``count``, ``mu``
and ``nu`` fields are found by name, so the bridge needs no optax.

An RLlib algorithm's state crosses with one function an algorithm
(``sac_state_from_jax``, ``td3_state_from_jax``, ``bc_state_from_jax``,
``cql_state_from_jax``, ``marwil_state_from_jax``,
``ma_ppo_state_from_jax``): the JAX algorithm's ``get_state()`` as numpy
becomes the port's ``set_state`` input — params and targets as tensors,
each optax Adam state as ``{"count", "mu", "nu"}`` (TD3's actor and
critic pair a tuple of two; MA-PPO's per-agent counts, which move
together, one count).

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
    # ascontiguousarray makes a 0-d leaf (CLIP's logit_scale) 1-d: the
    # reshape puts its shape back.
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16).reshape(a.shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(
        np.ascontiguousarray(a).reshape(a.shape).copy()).to(device)


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict of numpy arrays → the same nesting of tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):  # RLlib's MLP layer lists
        return [params_from_jax(v, dev) for v in tree]
    return _leaf_to_torch(tree, dev)


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def experts_from_jax(moe: Any, ep_index: int, ep: int,
                     device: DeviceLike = None) -> Any:
    """A rank's part of one JAX MoE layer (``{"w_router", "w_gate",
    "w_up", "w_down"}`` as numpy, experts leading) for expert parallelism
    over ``ep`` ranks: the router whole and the expert leaves' slice
    ``ep_index`` of E/ep, as ``params_from_jax`` gives them."""
    out = {}
    for k, v in moe.items():
        if k in EXPERT_LEAVES:
            n = v.shape[0] // ep
            v = np.asarray(v)[ep_index * n:(ep_index + 1) * n]
        out[k] = v
    return params_from_jax(out, device)


def params_to_numpy(tree: Any, bf16_dtype: Optional[Any] = None) -> Any:
    """Inverse of ``params_from_jax``: tensors → numpy on the host.

    A bf16 tensor comes back bit-exactly as ``bf16_dtype`` (pass
    ``jnp.bfloat16`` or ``ml_dtypes.bfloat16``) through a 16-bit view;
    without it, as float32, which holds every bf16 value exactly.  The
    arrays never share memory with the tensors (the port updates params
    in place)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v, bf16_dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_numpy(v, bf16_dtype) for v in tree]
    t = tree.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
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


def _state_to_numpy(tree: Any, bf16_dtype: Optional[Any]) -> Any:
    if isinstance(tree, (tuple, list)):
        return type(tree)(_state_to_numpy(v, bf16_dtype) for v in tree)
    if isinstance(tree, dict):
        return {k: _state_to_numpy(v, bf16_dtype) for k, v in tree.items()}
    return params_to_numpy(tree, bf16_dtype)


def opt_state_to_numpy(opt_state: Any, bf16_dtype: Optional[Any] = None
                       ) -> Any:
    """``train.AdamW``'s or ``train.adamw8bit``'s state → ``{"count": int,
    "mu": ..., "nu": ...}`` with numpy moments (bf16 ones as
    ``params_to_numpy`` returns them; int8 states as ``(q, scale)``
    tuples)."""
    return {"count": int(opt_state["count"]),
            "mu": _state_to_numpy(opt_state["mu"], bf16_dtype),
            "nu": _state_to_numpy(opt_state["nu"], bf16_dtype)}


def _moment_from_jax(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _moment_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_moment_from_jax(v, device) for v in tree)
    return _leaf_to_torch(tree, device)


def _adam_states(chain: Any) -> list:
    """The states of an optax chain state (NamedTuples in tuples) that
    hold ``count``, ``mu`` and ``nu``."""
    if hasattr(chain, "_fields"):
        return [chain] if {"count", "mu", "nu"} <= set(chain._fields) else []
    if isinstance(chain, (tuple, list)):
        return [st for c in chain for st in _adam_states(c)]
    return []


def opt_state_from_jax(chain_state: Any, device: DeviceLike = None) -> Any:
    """An optax chain state as numpy (``jax.tree.map(np.asarray,
    state)``) → the port's ``{"count", "mu", "nu"}`` from its one Adam
    state, on ``device``; an int8 state's ``(q, scale)`` pairs stay
    pairs."""
    dev = resolve_device(device)
    found = _adam_states(chain_state)
    if len(found) != 1:
        raise ValueError(f"want one Adam state (count, mu, nu) in the "
                         f"chain, found {len(found)}")
    st = found[0]
    return {"count": int(np.asarray(st.count)),
            "mu": _moment_from_jax(st.mu, dev),
            "nu": _moment_from_jax(st.nu, dev)}


def opt_state_to_jax(opt_state: Any, like: Any,
                     bf16_dtype: Optional[Any] = None) -> Any:
    """The port's state put back into ``like``, an optax chain state of
    the same optimizer (e.g. its ``init``): every ``count`` field (the
    Adam state's and the schedule's, which advance together) and the
    Adam state's ``mu`` and ``nu`` replaced by numpy values."""
    host = opt_state_to_numpy(opt_state, bf16_dtype)

    def walk(chain):
        if hasattr(chain, "_fields"):
            return chain._replace(**{
                f: (np.asarray(host[f], np.int32) if f == "count"
                    else host[f])
                for f in chain._fields if f in ("count", "mu", "nu")})
        if isinstance(chain, (tuple, list)):
            return type(chain)(walk(c) for c in chain)
        return chain

    return walk(like)


# --- RLlib algorithm states ---------------------------------------------------

def _adam_from_jax(chain_state: Any, device: torch.device) -> Any:
    """One optax Adam chain state → ``{"count", "mu", "nu"}``; a stacked
    per-agent state's counts (all equal) become one count."""
    found = _adam_states(chain_state)
    if len(found) != 1:
        raise ValueError(f"want one Adam state (count, mu, nu) in the "
                         f"chain, found {len(found)}")
    st = found[0]
    counts = np.unique(np.asarray(st.count))
    if counts.size != 1:
        raise ValueError(f"per-agent Adam counts differ: {counts}")
    return {"count": int(counts[0]), "mu": _moment_from_jax(st.mu, device),
            "nu": _moment_from_jax(st.nu, device)}


def _rl_state_from_jax(state: Any, trees, device: DeviceLike,
                       pair: bool = False) -> dict:
    """``trees`` as tensors, the Adam state (``pair``: a tuple of two),
    every other entry (counters) as it is."""
    dev = resolve_device(device)
    out = {k: v for k, v in state.items()
           if k not in trees and k != "opt_state"}
    out.update({k: params_from_jax(state[k], dev) for k in trees})
    opt = state["opt_state"]
    out["opt_state"] = (tuple(_adam_from_jax(o, dev) for o in opt) if pair
                        else _adam_from_jax(opt, dev))
    return out


def sac_state_from_jax(state: Any, device: DeviceLike = None) -> dict:
    """JAX SAC's ``get_state()`` (numpy leaves) → the port's: ``params``
    (actor, twin critics, ``log_alpha``), ``target_q`` and the one Adam
    over the whole tree, on ``device``."""
    return _rl_state_from_jax(state, ("params", "target_q"), device)


def td3_state_from_jax(state: Any, device: DeviceLike = None) -> dict:
    """JAX TD3's or DDPG's ``get_state()`` → the port's: ``params``,
    ``target`` and the ``(actor_opt, critic_opt)`` pair."""
    return _rl_state_from_jax(state, ("params", "target"), device,
                              pair=True)


def bc_state_from_jax(state: Any, device: DeviceLike = None) -> dict:
    """JAX BC's ``get_state()`` → the port's (``params``, its Adam)."""
    return _rl_state_from_jax(state, ("params",), device)


def cql_state_from_jax(state: Any, device: DeviceLike = None) -> dict:
    """JAX CQL's ``get_state()`` → the port's (``params``, ``target_q``,
    its Adam)."""
    return _rl_state_from_jax(state, ("params", "target_q"), device)


def marwil_state_from_jax(state: Any, device: DeviceLike = None) -> dict:
    """JAX MARWIL's ``get_state()`` → the port's (``params``, its Adam,
    ``adv_norm`` as a float)."""
    out = _rl_state_from_jax(state, ("params",), device)
    out["adv_norm"] = float(np.asarray(state["adv_norm"]))
    return out


def ma_ppo_state_from_jax(state: Any, device: DeviceLike = None) -> dict:
    """JAX MultiAgentPPO's ``get_state()`` → the port's: the stacked [A,
    ...] ``params`` and one Adam over them (the per-agent counts, equal,
    as one)."""
    return _rl_state_from_jax(state, ("params",), device)
