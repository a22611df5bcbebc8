"""Train state and optimizer (port of ``ray_tpu/train/state.py``).

``TrainState(step, params, opt_state)`` as in the JAX package, with the
step a host integer.  ``default_optimizer`` is the JAX package's
``optax.chain(clip_by_global_norm, adamw(schedule, ..., mu_dtype))``
written out in PyTorch, operation for operation in optax's order, so a
run of the port and a run of the JAX package from the same weights and
batches agree to rounding: the schedule reads the update count before
it is incremented (the first update takes the schedule's value at 0, so
after a warmup from 0 it leaves the params as they were), the
clip scales by ``max_norm / ‖g‖`` only when ``‖g‖ >= max_norm``, Adam's
bias correction divides both moments, eps is added outside the square
root, the decoupled weight decay ``lr·wd·p`` applies to every leaf, the
first moment is stored in ``mu_dtype`` and the second in the param
dtype.  ``torch.optim.AdamW`` cannot keep the first moment in bf16 and
orders its update differently.

The update runs in place on the params and moments (the JAX step
donates its state buffers, so no caller keeps the old one), a leaf of
more than ``_UPDATE_SLICE`` elements one slice of its leading axis at a
time: every operation of the update is elementwise, so the slices give
the whole leaf's bits while the temporaries stay one slice in size.
The global norm is ``optax.global_norm``'s: each leaf's ``sum(g*g)`` in
the leaf's dtype (a bf16 square summed in f32, rounded back to bf16, as
``jnp.sum`` does), summed over the leaves left to right in the promoted
dtype (all-bf16 stays bf16), its square root in that dtype.  The
layouts of a state over a mesh (``state_shardings``, ZeRO) are in
``train/zero.py``; under them the data-parallel step (``train/step.py``)
hands ``update_`` each rank's regions of the params and grads with the
global norm it took over the shards (``gnorm``), and the update is the
same elementwise work on a part of each leaf.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Schedule = Callable[[int], float]


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


# --- param trees (nested dicts of tensors) ----------------------------------

def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in the JAX package's order (dict keys sorted, lists in
    order), so sums over leaves run in the order optax's run.  A tuple is
    a leaf (optim8's ``(q, scale)`` pairs)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """Inverse of ``tree_leaves``: ``leaves`` put back in ``like``'s
    nesting."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            out = {k: walk(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(like)


def create_train_state(params: Any, tx: "AdamW") -> TrainState:
    """Step 0, the params as leaf tensors that take gradients (sharing
    storage with the given ones), and ``tx``'s initial state."""
    params = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    return TrainState(step=0, params=params, opt_state=tx.init(params))


# --- optax's schedules ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _as(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: a Python scalar meets a JAX array in the
    array's dtype (0.9 · a bf16 moment multiplies by bf16(0.9))."""
    return float(torch.tensor(x, dtype=dtype))


def _cast(x, dtype: torch.dtype):
    """A Python scalar rounded to ``dtype`` (``_as``), or a tensor cast."""
    return x.to(dtype) if isinstance(x, torch.Tensor) else _as(x, dtype)


def _f32(x: float) -> float:
    """Round to float32, the type optax computes its schedules in."""
    return _as(x, torch.float32)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: init → end over ``transition_steps``
    counts, then end."""
    if transition_steps <= 0:
        return lambda count: _f32(init_value)

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return _f32((init_value - end_value) * frac + end_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return _f32(init_value * ((1 - alpha) * cosine + alpha))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warmup to the peak,
    then a cosine decay over the remaining ``decay_steps - warmup_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


# --- the optimizer ----------------------------------------------------------

# Leaves above this many elements update one slice of their leading axis
# at a time (Mamba-2 2.7B's stacked in-projection is 1.7 G elements: whole,
# its f32 temporaries alone would take tens of GB).
_UPDATE_SLICE = 1 << 24


def _slices(p: torch.Tensor) -> List[Any]:
    if p.dim() == 0 or p.numel() <= _UPDATE_SLICE:
        return [...]  # the whole leaf, a 0-d one (CLIP's logit_scale) too
    rows = max(1, _UPDATE_SLICE // (p.numel() // p.shape[0]))
    return [slice(a, a + rows) for a in range(0, p.shape[0], rows)]


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the left-to-right sum over leaves of
    ``sum(g*g)`` in each leaf's dtype (bf16 squares summed in f32 and
    rounded back, as ``jnp.sum`` of bf16 does); the sum promotes as JAX
    does (bf16 + bf16 stays bf16, bf16 + f32 is f32)."""
    return torch.sqrt(sum((g * g).sum(dtype=torch.float32).to(g.dtype)
                          for g in leaves))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    eps, mu_dtype=mu_dtype, weight_decay=weight_decay))`` over a param
    tree.  ``init(params)`` gives ``{"count": 0, "mu": ..., "nu": ...}``;
    ``update_(params, grads, opt_state)`` updates params and moments in
    place and returns ``(new_opt_state, global norm of the unclipped
    grads)``."""

    schedule: Schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    grad_clip: Optional[float] = 1.0  # None or 0: no clip
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: Any) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype,
                requires_grad=False), params),
            "nu": tree_map(lambda p: torch.zeros_like(
                p, requires_grad=False), params),
        }

    def bias_corrections(self, count: int) -> Tuple[float, float]:
        """Adam's ``1 - b ** count`` for both moments, in float32 as optax
        computes them."""
        return (_f32(1 - _f32(self.b1) ** count),
                _f32(1 - _f32(self.b2) ** count))

    @torch.no_grad()
    def update_(self, params: Any, grads: Any, opt_state: Dict[str, Any],
                bias: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                gnorm: Optional[torch.Tensor] = None
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
        """``bias``: the two bias corrections as 0-d tensors on the
        params' device, read there instead of made from the count (an
        update captured once in a CUDA graph replays with each count's).
        ``gnorm``: the global norm of the grads when ``grads`` holds only
        a part of them (a ZeRO shard); default ``global_norm(grads)``."""
        ps, gs = tree_leaves(params), tree_leaves(grads)
        mus, nus = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
        count = opt_state["count"]
        count_inc = count + 1
        # Scalars as optax computes them (float32), each rounded to the
        # dtype of the array it meets.
        bc1, bc2 = bias if bias is not None else self.bias_corrections(
            count_inc)
        step_size = -self.schedule(count)
        if gnorm is None:
            gnorm = global_norm(gs)
        keep = (gnorm < _as(self.grad_clip, gnorm.dtype) if self.grad_clip
                else None)
        for p, g, mu, nu in zip(ps, gs, mus, nus):
            for sl in _slices(p):
                self._update_leaf(p[sl], g[sl], mu[sl], nu[sl], keep, gnorm,
                                  bc1, bc2, step_size)
        return dict(opt_state, count=count_inc), gnorm

    def _update_leaf(self, p, g, mu, nu, keep, gnorm, bc1, bc2, step_size):
        """optax's clip and adamw on one leaf (or slice of one), in place."""
        b1, b2 = self.b1, self.b2
        dt = g.dtype
        if keep is not None:
            g = torch.where(keep, g,
                            (g / gnorm.to(dt)) * _as(self.grad_clip, dt))
        mu_new = _as(1 - b1, dt) * g + _as(b1, mu.dtype) * mu
        nu_new = _as(1 - b2, dt) * (g * g) + _as(b2, nu.dtype) * nu
        u = ((mu_new / _cast(bc1, mu_new.dtype))
             / (torch.sqrt(nu_new / _cast(bc2, nu_new.dtype))
                + _as(self.eps, nu_new.dtype)))
        if self.weight_decay:  # optax.adam has no decay term at all
            u = u + _as(self.weight_decay, p.dtype) * p
        p.copy_(p + _as(step_size, u.dtype) * u)
        mu.copy_(mu_new)
        nu.copy_(nu_new)


def default_optimizer(
    learning_rate: float | Schedule = 3e-4,
    *,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    warmup_steps: int = 100,
    total_steps: Optional[int] = None,
    mu_dtype: Optional[torch.dtype] = None,
) -> AdamW:
    """AdamW with cosine schedule + global-norm clipping (LLM defaults),
    as the JAX package's.  ``mu_dtype=torch.bfloat16`` halves the
    first-moment buffer; the variance stays in the param dtype."""
    if callable(learning_rate):
        schedule = learning_rate
    elif total_steps:
        schedule = warmup_cosine_decay_schedule(
            0.0, learning_rate, warmup_steps,
            max(total_steps, warmup_steps + 1))
    else:
        schedule = linear_schedule(0.0, learning_rate, max(warmup_steps, 1))
    return AdamW(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                 grad_clip=grad_clip, mu_dtype=mu_dtype)
