"""The training step (port of ``ray_tpu/train/step.py``).

One step is forward, backward (autograd), and the optimizer update.
PyTorch runs eagerly, so there is nothing to jit: ``compile_train_step``
returns the step itself, whose first call registers ``train.step`` in
the device plane (``util/xprof``) with its analytic flops and that
call's wall, as the JAX step registers its compiled program.  The step
updates the state in place and returns it, as the JAX step donates its
buffers.

Over several data members (a ``zero.StepLayout`` over a mesh of ranks)
the step writes out the collectives GSPMD puts into the JAX program,
the pattern of arXiv 2004.13336:

* params split at rest (the ``fsdp`` axis) are all-gathered whole
  before the forward; leaves split over ``ep`` (Mixtral's experts and
  router columns) stay this rank's part, which the model uses or
  gathers itself (the data members are those at the rank's ``ep``
  coordinate);
* each rank runs its rows of the batch, with the data group published
  to the loss (``parallel/loss_split.py``), and splits the loss as the
  loss declares: ``"tokens"`` (its loss and grads weighted by its share
  of the global token count: Llama, Mamba-2), ``"rows"`` (by its share
  of the global rows: ViT) or ``"global"`` (the loss returns its share
  of the global objective itself: Mixtral's global routing, CLIP's
  all-gathered negatives), so the sum over ranks is the global batch's
  loss, as JAX takes it; a loss that declares nothing and whose aux is
  not ``loss`` and ``ntokens`` alone is refused;
* without ZeRO the grads are all-reduced and every rank updates its
  at-rest part; with ZeRO they are reduce-scattered to the moments'
  layout, each rank updates its region with the global norm (an
  all-reduce of the shards' squares, each region counted once, each
  ``ep`` part once), and the updated regions are all-gathered back;
* metrics are reduced, so every rank reports the global loss, grad
  norm, token count and, for a ``"global"`` split, every aux value
  summed (Mixtral's ``ce_loss`` and ``aux_loss``).

A step built with a layout runs this path at any world size; one data
member splits nothing, and the collectives are over a group of one.
Only a step without a layout (no process group) is the single-device
step.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import loss_split
from ray_tpu_torch.parallel.collectives import gather_single, scatter_single
from ray_tpu_torch.train.state import (
    AdamW,
    TrainState,
    global_norm,
    tree_leaves,
    tree_unflatten,
)

log = logging.getLogger(__name__)

# The aux keys of a loss that the data-parallel step may split by tokens.
TOKEN_SPLIT = frozenset({"loss", "ntokens"})

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


def _grad(loss, leaves):
    # A leaf the loss never reads (CLIP's vision head at 0 classes) gets
    # zeros, as jax.grad gives it.
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, gs)]


def _gather_params(state: TrainState, layout) -> List[torch.Tensor]:
    """Every param leaf whole: a leaf split at rest is all-gathered over
    the data members into a fresh leaf that takes grads."""
    out = []
    for leaf, p in zip(layout.leaves, tree_leaves(state.params)):
        if not leaf.rest_split:
            out.append(p)
            continue
        with torch.no_grad():
            buf = p.new_empty((leaf.n, p.numel()))
            gather_single(buf, p.detach(), layout.group)
            if leaf.rest_ordered():
                full = buf.view(leaf.shape)
            else:
                full = p.new_empty(leaf.shape)
                leaf.gather_into(full, buf, "rest")
        out.append(full.requires_grad_(p.requires_grad))
    return out


def _grad_norm(layout, grads: List[torch.Tensor], gs: List[torch.Tensor]
               ) -> torch.Tensor:
    """``optax.global_norm`` of the whole model's grads: each leaf's f32
    sum of squares, each region once (ZeRO: summed over the members,
    each counting the regions it owns from ``gs``; replicated: every
    member holds ``grads`` whole; ``ep``: leaves split over ``ep`` summed
    over it, the others taken once), rounded to the leaf's dtype, the
    leaves summed left to right.  Replicated at ``ep`` 1:
    ``global_norm`` of the grads."""
    if not layout.zero and layout.ep == 1:
        return global_norm(grads)  # every rank holds them whole
    sq = [(g * g).sum(dtype=torch.float32)
          for g in (gs if layout.zero else grads)]
    if layout.zero:
        sq = [s if leaf.owner else torch.zeros_like(s)
              for s, leaf in zip(sq, layout.leaves)]
    sums = torch.stack(sq)
    if layout.zero and layout.group is not None:
        dist.all_reduce(sums, group=layout.group)
    if layout.ep > 1:
        once = torch.tensor([1.0 if split or layout.ep_index == 0 else 0.0
                             for split in layout.ep_split],
                            device=sums.device)
        sums = sums * once
        dist.all_reduce(sums, group=layout.ep_group)
    return torch.sqrt(sum(s.to(g.dtype) for s, g in zip(sums, gs)))


def _sharded_update(tx, state: TrainState, full: List[torch.Tensor],
                    grads: List[torch.Tensor], layout):
    """Reduce the local grads over the data members, update each rank's
    regions, and put the updated params back where they live."""
    group = layout.group
    ps, gs = [], []
    for leaf, p, g in zip(layout.leaves, full, grads):
        if layout.zero and leaf.update_split:
            buf = leaf.pack_update(g)
            out = g.new_empty(leaf.update_numel())
            scatter_single(out, buf, group)
            del buf
            pv = leaf.update_view(p)
            gv = out[:pv.numel()].view(pv.shape)
        else:
            if group is not None:
                dist.all_reduce(g, group=group)
            pv = leaf.update_view(p) if leaf.update_split else p
            gv = leaf.update_view(g) if leaf.update_split else g
        ps.append(pv)
        gs.append(gv)
    gnorm = _grad_norm(layout, grads, gs)
    opt_state, gnorm = tx.update_(tree_unflatten(state.params, ps),
                                  tree_unflatten(state.params, gs),
                                  state.opt_state, gnorm=gnorm)
    with torch.no_grad():
        for leaf, p, pv, st in zip(layout.leaves, full, ps,
                                   tree_leaves(state.params)):
            if leaf.update_split and not leaf.same_regions:
                m = leaf.update_numel()
                mine = pv.reshape(-1)
                if mine.numel() < m:  # the last block pair's padding
                    mine = torch.nn.functional.pad(mine,
                                                   (0, m - mine.numel()))
                chunks = p.new_empty((leaf.n, m))
                gather_single(chunks, mine.clone(), group)
                leaf.gather_into(p, chunks, "update")
            if leaf.rest_split:
                st.copy_(p[leaf.rest_slices()])
    return opt_state, gnorm


def _refusal(layout, aux, split) -> NotImplementedError:
    what = f"the split {split!r}" if split else "no split"
    return NotImplementedError(
        f"the data-parallel step splits a loss over {layout.n} data "
        f"members as the loss declares (ray_tpu_torch.parallel.loss_split"
        f".declare: 'tokens', 'rows' or 'global'); this loss declares "
        f"{what}, and its aux {sorted(aux)} does not fit it (a token "
        f"split's is 'loss' and the member's 'ntokens'; a row split's "
        f"'loss' alone).  A loss that depends on the whole batch reads "
        f"the step's data group and returns its share of the global "
        f"objective (the 'global' split: Mixtral's and CLIP's losses)")


def make_train_step(loss_fn: LossFn, tx: AdamW, *, grad_accum: int = 1,
                    layout=None) -> Step:
    """Returns step(state, batch) -> (state, metrics).

    ``grad_accum > 1`` splits the batch's leading dim into that many
    microbatches and accumulates their grads in place, in the param
    dtype, from zeros, in order (the JAX scan's sum), then divides once
    in place before the single optimizer update.  Metrics are the loss
    function's aux (from the last microbatch), then ``loss`` (the mean
    over microbatches), ``grad_norm`` (global norm of the unclipped
    grads, in their dtype, as ``optax.global_norm`` takes it) and
    ``step`` (the step before this one), as tensors on the device and a
    host int: nothing here waits for the device.

    ``layout``: a ``zero.StepLayout`` for a step over several data
    members (the trainer builds it); the batch is then this rank's rows
    (``TorchTrainer.shard_batch``), each microbatch's loss runs with the
    data group published (``parallel/loss_split.py``) and is split as it
    declares, and the aux reported is the global one."""
    sharded = layout is not None

    def _group(batch) -> loss_split.DataGroup:
        rows = next(iter(batch.values())).shape[0] if batch else 0
        return loss_split.DataGroup(
            layout.mesh, layout.data_axes, layout.n,
            layout.index or 0, layout.order or tuple(range(layout.n)),
            rows * layout.n, layout.ep, layout.ep_index)

    def _share(loss, aux, split, group):
        """This member's share of the global (micro)batch's loss, and the
        aux with the global count, by the declared split."""
        token_aux = "ntokens" in aux and set(aux) <= TOKEN_SPLIT
        if split is None and token_aux:
            split = "tokens"
        if layout.n == 1:
            return loss, aux, split
        if split is None or (split == "rows" and set(aux) - {"loss"}) or (
                split == "tokens" and not token_aux):
            raise _refusal(layout, aux, split)
        if split in ("rows", "global") and layout.order is None:
            raise NotImplementedError(
                f"a {split!r} split needs the batch rows cut one chunk a "
                f"data member (the 'batch' rule over the data axes "
                f"{layout.data_axes})")
        if split == "global":
            return loss, aux, split
        if split == "rows":  # the members hold equal rows (shard_batch)
            return loss / layout.n, aux, split
        c = aux["ntokens"].detach().float().reshape(())
        total = group.total(c)
        return (loss * (c / total.clamp_min(1.0)),
                dict(aux, ntokens=total), split)

    def _run(params, batch, backward):
        """The loss of one (micro)batch, split, and ``backward(loss)``,
        with the data group published to both."""
        if not sharded:
            loss, aux = loss_fn(params, batch)
            return loss, aux, None, backward(loss)
        group = _group(batch)
        with loss_split.publish(group) as frame:
            loss, aux = loss_fn(params, batch)
            loss, aux, split = _share(loss, aux, frame.split, group)
            return loss, aux, split, backward(loss)

    def _grads(params, leaves, batch):
        if grad_accum <= 1:
            loss, aux, split, grads = _run(
                params, batch, lambda loss: _grad(loss, leaves))
            return loss.detach(), aux, split, grads

        def split_rows(x):
            if x.shape[0] % grad_accum:
                raise ValueError(
                    f"batch dim {x.shape[0]} not divisible by "
                    f"grad_accum={grad_accum}")
            return x.reshape(grad_accum, x.shape[0] // grad_accum,
                             *x.shape[1:])

        micro = {k: split_rows(v) for k, v in batch.items()}
        for p in leaves:
            p.grad = torch.zeros_like(p)
        try:
            loss_sum, aux, split = None, None, None
            for i in range(grad_accum):
                loss, aux, split, _ = _run(
                    params, {k: v[i] for k, v in micro.items()},
                    lambda loss: loss.backward(inputs=leaves))
                loss = loss.detach().float()
                loss_sum = loss if loss_sum is None else loss_sum + loss
            grads = [p.grad for p in leaves]
        finally:
            for p in leaves:
                p.grad = None
        for g in grads:
            g.div_(grad_accum)
        return loss_sum / grad_accum, aux, split, grads

    def _global_aux(aux, split):
        """A 'global' split's aux summed over the members (one
        all-reduce of the tensor values)."""
        if split != "global" or layout.group is None:
            return aux
        keys = [k for k, v in aux.items() if torch.is_tensor(v)]
        if not keys:
            return aux
        vals = torch.stack([aux[k].detach().float().reshape(())
                            for k in keys])
        dist.all_reduce(vals, group=layout.group)
        return dict(aux, **dict(zip(keys, vals.unbind(0))))

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if not sharded:
            loss, aux, _, grads = _grads(state.params,
                                         tree_leaves(state.params), batch)
            opt_state, gnorm = tx.update_(
                state.params, _unflatten_like(state.params, grads),
                state.opt_state)
        else:
            full = _gather_params(state, layout)
            loss, aux, split, grads = _grads(
                tree_unflatten(state.params, full), full, batch)
            if layout.group is not None:
                loss = loss.float()
                dist.all_reduce(loss, group=layout.group)
            aux = _global_aux(aux, split)
            opt_state, gnorm = _sharded_update(tx, state, full, grads,
                                               layout)
        # Canonical keys win over aux duplicates: under grad_accum the aux
        # rides from the last microbatch only, while ``loss`` is the mean
        # over all of them.
        metrics = {**{k: v.detach() if torch.is_tensor(v) else v
                      for k, v in aux.items()},
                   "loss": loss, "grad_norm": gnorm, "step": state.step}
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return step


def _step_flops(params: Any, batch: Dict[str, torch.Tensor],
                num_params: Optional[int] = None) -> Optional[float]:
    """A step's analytic flops (``xprof.train_step_flops``): 6 x params x
    tokens, plus causal attention when the tree is a Llama's (its
    ``layers.attn.wq`` is [L, dim, heads, head_dim]); other trees count
    the weights only.  None for a batch without ``tokens``.
    ``num_params``: the whole model's count when ``params`` are shards."""
    from ray_tpu_torch.util import xprof

    tokens = batch.get("tokens")
    if not isinstance(tokens, torch.Tensor):
        return None
    n_params = num_params or sum(int(t.numel()) for t in tree_leaves(params))
    wq = params.get("layers", {}).get("attn", {}).get("wq") \
        if isinstance(params, dict) else None
    if isinstance(wq, torch.Tensor) and wq.dim() == 4 and not num_params:
        L, _d, H, hd = wq.shape
        return xprof.train_step_flops(n_params, tokens.numel(), L, H, hd,
                                      tokens.shape[-1])
    return 6.0 * n_params * tokens.numel()


def _instrument_first_call(step: Step, num_params: Optional[int] = None
                           ) -> Step:
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
            flops = _step_flops(state.params, batch, num_params)
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
                       grad_accum: int = 1, layout=None) -> Step:
    """The step, its first call registered in the device plane.
    ``layout`` (a ``zero.StepLayout``) runs it over the data members of
    a mesh; ``zero_sharding=True`` needs one, built with the ZeRO layout
    over an initialised process group (``TorchTrainer`` builds it; a
    group of one rank will do)."""
    if zero_sharding and (layout is None or not layout.zero):
        raise NotImplementedError(
            "zero_sharding shards the optimizer state over the data axes "
            "of a mesh laid over a torch.distributed process group: "
            "initialise one (ray_tpu_torch.train.backend."
            "init_process_group) and build the step from its ZeRO layout "
            "(TorchTrainer does)")
    n = layout.num_params if layout is not None and any(
        leaf.rest_split or split for leaf, split in
        zip(layout.leaves, layout.ep_split)) else None
    return _instrument_first_call(
        make_train_step(loss_fn, tx, grad_accum=grad_accum, layout=layout),
        n)
