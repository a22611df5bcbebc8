"""The training step (port of ``ray_tpu/train/step.py``).

One step is forward, backward (autograd), and the optimizer update, on
one device.  PyTorch runs eagerly, so there is nothing to jit:
``compile_train_step`` returns the step itself, whose first call
registers ``train.step`` in the device plane (``util/xprof``) with its
analytic flops and that call's wall, as the JAX step registers its
compiled program.  The step updates the state in place and returns it,
as the JAX step donates its buffers.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch.train.state import AdamW, TrainState, tree_leaves

log = logging.getLogger(__name__)

LossFn = Callable[[Any, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
Step = Callable[[TrainState, Dict[str, torch.Tensor]],
                Tuple[TrainState, Dict[str, Any]]]


def _unflatten_like(tree: Any, leaves) -> Any:
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)

    return walk(tree)


def make_train_step(loss_fn: LossFn, tx: AdamW, *, grad_accum: int = 1
                    ) -> Step:
    """Returns step(state, batch) -> (state, metrics).

    ``grad_accum > 1`` splits the batch's leading dim into that many
    microbatches, sums their grads and divides once before the single
    optimizer update (the JAX scan's mean of means).  Metrics are the
    loss function's aux (from the last microbatch), then ``loss`` (the
    mean over microbatches), ``grad_norm`` (global norm of the unclipped
    grads, in their dtype, as ``optax.global_norm`` takes it) and ``step`` (the step before this one), as tensors on the
    device and a host int: nothing here waits for the device."""

    def _grad(loss, leaves):
        # A leaf the loss never reads (CLIP's vision head at 0 classes)
        # gets zeros, as jax.grad gives it.
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, gs)]

    def _grads(params, batch):
        leaves = tree_leaves(params)
        if grad_accum <= 1:
            loss, aux = loss_fn(params, batch)
            return loss.detach(), aux, _grad(loss, leaves)

        def split(x):
            if x.shape[0] % grad_accum:
                raise ValueError(
                    f"batch dim {x.shape[0]} not divisible by "
                    f"grad_accum={grad_accum}")
            return x.reshape(grad_accum, x.shape[0] // grad_accum,
                             *x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        loss_sum, gsum, aux = None, None, None
        for i in range(grad_accum):
            loss, aux = loss_fn(params, {k: v[i] for k, v in micro.items()})
            g = _grad(loss, leaves)
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
        return (loss_sum / grad_accum, aux,
                [g / grad_accum for g in gsum])

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, aux, grads = _grads(state.params, batch)
        opt_state, gnorm = tx.update_(
            state.params, _unflatten_like(state.params, grads),
            state.opt_state)
        # Canonical keys win over aux duplicates: under grad_accum the aux
        # rides from the last microbatch only, while ``loss`` is the mean
        # over all of them.
        metrics = {**{k: v.detach() if torch.is_tensor(v) else v
                      for k, v in aux.items()},
                   "loss": loss, "grad_norm": gnorm, "step": state.step}
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return step


def _step_flops(params: Any, batch: Dict[str, torch.Tensor]
               ) -> Optional[float]:
    """A step's analytic flops (``xprof.train_step_flops``): 6 x params x
    tokens, plus causal attention when the tree is a Llama's (its
    ``layers.attn.wq`` is [L, dim, heads, head_dim]); other trees count
    the weights only.  None for a batch without ``tokens``."""
    from ray_tpu_torch.util import xprof

    tokens = batch.get("tokens")
    if not isinstance(tokens, torch.Tensor):
        return None
    n_params = sum(int(t.numel()) for t in tree_leaves(params))
    wq = params.get("layers", {}).get("attn", {}).get("wq") \
        if isinstance(params, dict) else None
    if isinstance(wq, torch.Tensor) and wq.dim() == 4:
        L, _d, H, hd = wq.shape
        return xprof.train_step_flops(n_params, tokens.numel(), L, H, hd,
                                      tokens.shape[-1])
    return 6.0 * n_params * tokens.numel()


def _instrument_first_call(step: Step) -> Step:
    """Time the step's first call (on the card: the kernels' first-use
    builds and lazy CUDA init beside the enqueue) and register
    ``train.step`` with its analytic flops against the ``train.compute``
    span; later calls pass straight through."""
    called = []

    def wrapped(state, batch):
        if called:
            return step(state, batch)
        called.append(True)
        flops = None
        try:
            flops = _step_flops(state.params, batch)
        except Exception:
            log.exception("train.step: no analytic flop count")
        t0 = time.time()
        out = step(state, batch)
        elapsed = time.time() - t0
        try:
            from ray_tpu_torch.util import xprof

            xprof.record_program("train.step", flops=flops,
                                 compile_time_s=elapsed,
                                 span_name="train.compute",
                                 compiled_at=t0 + elapsed)
        except Exception:
            log.exception("device plane: recording train.step failed")
        return out

    wrapped.__wrapped__ = step
    return wrapped


def compile_train_step(loss_fn: LossFn, tx: AdamW, *,
                       zero_sharding: bool = False,
                       grad_accum: int = 1) -> Step:
    """The step for one device, its first call registered in the device
    plane.  ZeRO sharding of the optimizer state needs several devices:
    not ported yet."""
    if zero_sharding:
        raise NotImplementedError(
            "zero_sharding shards the optimizer state over several devices: "
            "not ported to ray_tpu_torch yet (see ROADMAP.md)")
    return _instrument_first_call(
        make_train_step(loss_fn, tx, grad_accum=grad_accum))
