"""Block-wise 8-bit Adam states (port of ``ray_tpu/train/optim8.py``).

Adam's m and v live as int8 with one float32 absmax scale per
256-element block: 2 bytes of optimizer state a parameter instead of
8, which is what lets bench.py's 2.24B point (``BENCH_2B_CFG``) train
with bf16 master weights.  As in the JAX package the second moment is
stored as its square root (a linear int8 code spans a 127:1 ratio per
block; the root doubles the dynamic range that covers), the update is
clipped to +-10, and a leaf is updated in block space one segment of at
most ``ceil(blocks / 16)`` blocks at a time, so the float32 transients
stay a sixteenth of the leaf.  Every operation is per block or
elementwise, so the segments give the whole leaf's bits.

``adamw8bit`` is optax's chain written out as the port's ``AdamW`` is:
``clip_by_global_norm`` (in the grads' dtype), the 8-bit Adam,
``add_decayed_weights`` and ``scale_by_learning_rate`` (the schedule
read at the count before the update), each Python scalar rounded to the
dtype of the array it meets (``state._as``).  ``init(params)`` gives
``{"count": 0, "mu": ..., "nu": ...}`` with an ``(int8 [nb, 256],
float32 [nb, 1])`` pair at each param leaf; ``update_`` updates params
and states in place.

Under ZeRO (``TrainerConfig(zero_sharding=True)``, ``train/zero.py``)
each rank holds its blocks of every leaf, ``[a, b)`` of the leaf's
``nb``, and ``update_`` takes that rank's flat slices ``[256 a, min(256
b, numel))`` of the params and grads with the global norm: the update
is per block, so the blocks a rank updates come out with the bits the
whole leaf would give them.

Divisions are true quotients on every device: the divisors are device
tensors (on a CUDA tensor ``x / 127.0`` is a product with the
reciprocal).  The JAX quantiser runs under ``jit``, where XLA turns
``/ 127.0`` and ``/ scale`` into reciprocal products, so the port's
scales can sit one ulp and its int8 values one step from the JAX ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.train.state import (
    Schedule,
    _as,
    _f32,
    global_norm,
    linear_schedule,
    tree_leaves,
    tree_map,
    warmup_cosine_decay_schedule,
)

BLOCK = 256
_SEGMENTS = 16


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true quotient (a device tensor divisor)."""
    return x / torch.full((1,), d, dtype=x.dtype, device=x.device)


def _quantize_blocks(blocks: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 [nb, BLOCK] → (int8 [nb, BLOCK], float32 scale [nb, 1]):
    scale = max(absmax / 127, 1e-12), q = clip(round(x / scale))
    (round half to even, as ``jnp.round``)."""
    scale = _div(blocks.abs().amax(dim=1, keepdim=True), 127.0)
    scale = scale.clamp_min(1e-12)
    q = torch.round(blocks / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any tensor, flattened to float32 and zero-padded to whole blocks →
    (int8 [nb, BLOCK], float32 scale [nb, 1])."""
    flat = x.reshape(-1).float()
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    return _quantize_blocks(flat.reshape(-1, BLOCK))


def _dequantize(s: Tuple[torch.Tensor, torch.Tensor], shape) -> torch.Tensor:
    q, scale = s
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


@dataclasses.dataclass(frozen=True)
class ScaleByAdam8bit:
    """Adam moment tracking with int8 block-quantised m and sqrt(v):
    ``init(params)`` and ``update(grads, state) -> (updates, state)``,
    the updates in the grads' dtype (optax's ``scale_by_adam8bit``)."""

    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    def init(self, params: Any) -> Dict[str, Any]:
        def zeros(p):
            return _quantize(torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device))

        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def _segment(self, g32, mq, ms, nq, ns, bc1: float, bc2: float):
        """One segment of blocks: the update (float32, clipped) and the
        new int8 m and sqrt(v) with their scales."""
        b1, b2 = self.b1, self.b2
        m = mq.float() * ms
        u = nq.float() * ns
        n = _f32(b2) * (u * u) + _f32(1 - b2) * (g32 * g32)
        m = _f32(b1) * m + _f32(1 - b1) * g32
        out = _div(m, bc1) / (torch.sqrt(_div(n, bc2)) + _f32(self.eps))
        out = out.clamp_(-10.0, 10.0)
        return (out, *_quantize_blocks(m), *_quantize_blocks(torch.sqrt(n)))

    def stream_leaf(self, g: torch.Tensor, mu, nu, count: int, emit,
                    grad_fn=None) -> None:
        """Update one leaf's states in place, one segment at a time, and
        hand each segment's update to ``emit(lo, hi, update)`` (flat
        element range, update in the grads' dtype).  ``grad_fn`` maps a
        flat slice of the grads before the update (the chain's clip)."""
        cf = count + 1
        bc1 = _f32(1 - _f32(self.b1) ** cf)
        bc2 = _f32(1 - _f32(self.b2) ** cf)
        (mq, ms), (nq, ns) = mu, nu
        flat = g.reshape(-1)
        n, nb = flat.numel(), mq.shape[0]
        rows = -(-nb // min(_SEGMENTS, nb))
        for a in range(0, nb, rows):
            b = min(a + rows, nb)
            lo, hi = a * BLOCK, min(b * BLOCK, n)
            gs = flat[lo:hi]
            if grad_fn is not None:
                gs = grad_fn(gs)
            g32 = F.pad(gs.float(), (0, (b - a) * BLOCK - (hi - lo)))
            out, mq2, ms2, nq2, ns2 = self._segment(
                g32.view(b - a, BLOCK), mq[a:b], ms[a:b], nq[a:b], ns[a:b],
                bc1, bc2)
            mq[a:b], ms[a:b], nq[a:b], ns[a:b] = mq2, ms2, nq2, ns2
            emit(lo, hi, out.reshape(-1)[:hi - lo].to(g.dtype))

    @torch.no_grad()
    def update(self, grads: Any, state: Dict[str, Any]
               ) -> Tuple[Any, Dict[str, Any]]:
        def leaf(g, mu, nu):
            mu = tuple(t.clone() for t in mu)
            nu = tuple(t.clone() for t in nu)
            out = torch.empty_like(g).reshape(-1)

            def emit(lo, hi, u):
                out[lo:hi] = u

            self.stream_leaf(g, mu, nu, state["count"], emit)
            return out.view(g.shape), mu, nu

        done = tree_map(leaf, grads, state["mu"], state["nu"])
        updates, mu, nu = (tree_map(lambda _g, d, i=i: d[i], grads, done)
                           for i in range(3))
        return updates, {"count": state["count"] + 1, "mu": mu, "nu": nu}


def scale_by_adam8bit(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                      *, shard_update: bool = False) -> ScaleByAdam8bit:
    """``shard_update=True``: the states' block dim is sharded over the
    ZeRO axes of a mesh laid over a ``torch.distributed`` process group,
    and each rank updates its blocks (use with
    ``TrainerConfig(zero_sharding=True)``).  It raises when no process
    group is initialised (``train/backend.init_process_group``; a group
    of one rank will do), where there is nothing to shard over.  Which
    blocks a rank updates is the step's ZeRO layout
    (``TrainerConfig(zero_sharding=True)``); the bits do not depend on
    it."""
    if shard_update:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise NotImplementedError(
                "shard_update shards the int8 Adam states over the ZeRO "
                "axes of a process group: initialise one first "
                "(ray_tpu_torch.train.backend.init_process_group)")
    return ScaleByAdam8bit(b1=b1, b2=b2, eps=eps)


@dataclasses.dataclass(frozen=True)
class AdamW8bit:
    """``optax.chain(clip_by_global_norm(grad_clip), scale_by_adam8bit(b1,
    b2, eps), add_decayed_weights(weight_decay),
    scale_by_learning_rate(schedule))`` over a param tree, the clip and
    the decay left out when zero.  ``update_(params, grads, opt_state)``
    updates params and states in place and returns ``(new_opt_state,
    global norm of the unclipped grads)``, as ``AdamW`` does."""

    schedule: Schedule
    adam: ScaleByAdam8bit = ScaleByAdam8bit()
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Any) -> Dict[str, Any]:
        return self.adam.init(params)

    @torch.no_grad()
    def update_(self, params: Any, grads: Any, opt_state: Dict[str, Any],
                gnorm: Optional[torch.Tensor] = None
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
        """``gnorm``: the global norm when ``grads`` holds only this
        rank's blocks (params and grads then flat slices of their
        leaves); default ``global_norm(grads)``."""
        ps, gs = tree_leaves(params), tree_leaves(grads)
        mus, nus = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
        count = opt_state["count"]
        step_size = -self.schedule(count)
        if gnorm is None:
            gnorm = global_norm(gs)
        clip = None
        if self.grad_clip:
            keep = gnorm < _as(self.grad_clip, gnorm.dtype)

            def clip(g):
                dt = g.dtype
                return torch.where(keep, g, (g / gnorm.to(dt))
                                   * _as(self.grad_clip, dt))

        for p, g, mu, nu in zip(ps, gs, mus, nus):
            flat = p.view(-1)

            def emit(lo, hi, u, flat=flat):
                pseg = flat[lo:hi]
                if self.weight_decay:
                    u = u + _as(self.weight_decay, pseg.dtype) * pseg
                pseg.copy_(pseg + _as(step_size, u.dtype) * u)

            self.adam.stream_leaf(g, mu, nu, count, emit, grad_fn=clip)
        return dict(opt_state, count=count + 1), gnorm


def adamw8bit(learning_rate: float = 3e-4, *, weight_decay: float = 0.1,
              b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
              grad_clip: float = 1.0, warmup_steps: int = 100,
              total_steps: Optional[int] = None,
              shard_update: bool = False) -> AdamW8bit:
    """AdamW with 8-bit states and the schedule and clipping of
    ``default_optimizer``, as the JAX package's ``adamw8bit``."""
    if total_steps:
        schedule = warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup_steps,
            max(total_steps, warmup_steps + 1))
    else:
        schedule = linear_schedule(0.0, learning_rate, max(1, warmup_steps))
    return AdamW8bit(schedule, scale_by_adam8bit(
        b1=b1, b2=b2, eps=eps, shard_update=shard_update),
        weight_decay=weight_decay, grad_clip=grad_clip)
