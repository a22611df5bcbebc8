"""Learner — one RL update on one device (port of
``ray_tpu/rllib/learner.py``).

``Learner.update_fn`` is the JAX package's: value-and-grad of the spec's
loss, then its optimizer.  The optimizer of every algorithm here is
optax's ``chain(clip_by_global_norm(c), adam(lr))`` (or a bare
``adam(lr)``), which :func:`adam` gives as ``train.AdamW`` with no weight
decay and a constant rate — the same rounding rules (optax's global
norm and clip, bias-corrected moments, eps outside the root), updating
params and moments in place.

A LearnerGroup of more than one learner (the JAX package's data-parallel
update, ``shard_map`` over a ``dp`` mesh axis) is not ported: it and
``dp_mesh`` raise NotImplementedError beyond one learner (ROADMAP.md
queue 1 item 6 part 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.train.state import (
    AdamW,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_MULTI = ("more than one learner (a data-parallel LearnerGroup) is not "
          "ported to ray_tpu_torch yet: ROADMAP.md queue 1 item 6 part 5, "
          "the multi-device item")


def adam(lr: float, grad_clip: Optional[float] = None) -> AdamW:
    """optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))``, or
    ``adam(lr)`` alone with no ``grad_clip``."""
    return AdamW(lambda count: lr, weight_decay=0.0, grad_clip=grad_clip)


def trainable(params: Any) -> Any:
    """The params as leaf tensors that take gradients."""
    return tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)


def value_and_grad(loss_fn: Callable, params: Any, *args):
    """``((loss, aux), grads)`` of ``loss_fn(params, *args) -> (loss,
    aux)``, grads in ``params``' nesting; a leaf the loss never reads gets
    zeros, as ``jax.grad`` gives."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        out = loss_fn(params, *args)
    grads = torch.autograd.grad(out[0], leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return out, tree_unflatten(params, grads)


def apply_gradients(optimizer: AdamW, params: Any, opt_state: Any,
                    loss_fn: Callable, *args):
    """One step of ``loss_fn`` (returning ``(loss, aux)``): params and
    moments updated in place.  Returns (opt_state, loss, aux, grad
    norm)."""
    (loss, aux), grads = value_and_grad(loss_fn, params, *args)
    opt_state, gnorm = optimizer.update_(params, grads, opt_state)
    return opt_state, loss.detach(), _detach(aux), gnorm


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


@dataclasses.dataclass
class LearnerSpec:
    """What a Learner needs to update a module: ``loss_fn(params, batch,
    rng) -> (loss, aux_dict)`` (a MEAN over the batch) and the
    optimizer."""

    loss_fn: Callable[[Any, Dict[str, torch.Tensor], Any], Any]
    optimizer: AdamW
    has_aux: bool = True


def dp_mesh(num_learners: int, devices: Optional[Sequence[Any]] = None,
            axis_name: str = "dp"):
    """One learner's device as a one-element tuple; more raise."""
    if num_learners > 1:
        raise NotImplementedError(f"dp_mesh({num_learners}): {_MULTI}")
    return (resolve_device(devices[0] if devices else None),)


class Learner:
    """Single-replica learner: one gradient update on one device."""

    def __init__(self, spec: LearnerSpec):
        self.spec = spec

    def init_optimizer(self, params):
        return self.spec.optimizer.init(params)

    def update_fn(self, params, opt_state, batch, rng=None):
        """(params, opt_state, metrics) after one SGD step, params and
        moments updated in place; metrics hold ``loss``, the unclipped
        ``grad_norm`` and the loss's aux."""
        loss_fn = self.spec.loss_fn
        if not self.spec.has_aux:
            loss_fn = lambda *a: (self.spec.loss_fn(*a), {})  # noqa: E731
        opt_state, loss, aux, gnorm = apply_gradients(
            self.spec.optimizer, params, opt_state, loss_fn, batch, rng)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, **aux}

    update = update_fn


class LearnerGroup:
    """The JAX package's data-parallel group, at one learner: the
    :class:`Learner`'s update.  More learners raise."""

    def __init__(self, spec: LearnerSpec, *, devices=None,
                 num_learners: Optional[int] = None, mesh=None,
                 axis_name: str = "dp"):
        n = num_learners if num_learners is not None else (
            len(mesh) if mesh is not None else
            len(devices) if devices is not None else 1)
        if n > 1:
            raise NotImplementedError(f"LearnerGroup(num_learners={n}): "
                                      f"{_MULTI}")
        self.learner = Learner(spec)
        self.axis_name = axis_name
        self.num_learners = 1

    def init(self, params):
        return params, self.learner.init_optimizer(params)

    def update(self, params, opt_state, batch, rng=None, *,
               rng_per_shard: bool = False):
        return self.learner.update_fn(params, opt_state, batch, rng)
