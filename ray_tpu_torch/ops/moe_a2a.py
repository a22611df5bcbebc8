"""Explicit expert-parallel MoE dispatch through an all-to-all (port of
``ray_tpu/ops/moe_a2a.py``).

The JAX op runs inside ``shard_map`` over the ``ep`` axis: each device
scatters its local tokens into capacity-bounded per-expert buffers,
exchanges them with one ``lax.all_to_all``, runs its local experts'
FFNs, reverses the exchange and combines (the DeepSpeed/Megatron
token-dispatch pipeline).  The port has no ``shard_map``: every rank on
the axis calls ``moe_block_ep`` with its own inputs, its rows and its
share of the experts, and the exchanges are ``all_to_all_grad`` over
the axis's process group (NCCL on the card, gloo on the CPU), whose
backward is the reverse exchange.

Capacity is per (device, expert): Cl = capacity(cfg, G_local), the
local token count.  One expert receives at most G_local assignments
from a device, so ``capacity_factor >= n_experts / experts_per_token``
drops nothing and equals the single-device block; tighter factors drop
each device's overflow, as Switch does.  This is not the trainer's
expert parallelism (``models/mixtral.moe_block`` over ``ep``), whose
capacity is global, as GSPMD's is.  As in the JAX package, the op
stands alone: the model does not call it.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel.mesh import Mesh


def moe_block_ep(x: torch.Tensor, moe: Any, cfg, *, mesh: Mesh,
                 axis: str = "ep") -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE block on this rank of ``axis``: ``x`` [B/ep,
    S, D] its rows of the batch, ``moe`` its E/ep experts' leaves
    (``w_gate``/``w_up``/``w_down``, experts leading) and the whole
    router.  Returns (out [B/ep, S, D], aux) like
    ``models/mixtral.moe_block``: aux is the mean over the axis of each
    rank's aux over its own rows (JAX's ``pmean``), whose backward hands
    each rank its share."""
    from ray_tpu_torch.models.mixtral import (_combine, _expert_ffn, _route,
                                              _scatter, capacity)

    ep = mesh.axis_size(axis)
    E, k = cfg.n_experts, cfg.experts_per_token
    if E % ep:
        raise ValueError(f"n_experts {E} not divisible by ep={ep}")
    e_local = E // ep
    if moe["w_gate"].shape[0] != e_local:
        raise ValueError(f"this rank holds {moe['w_gate'].shape[0]} experts; "
                         f"ep={ep} gives each {e_local} of {E}")
    bl, S, D = x.shape
    # The global batch must split evenly: every rank's buffers are the
    # same size, as the exchange needs.
    rows = C.allgather(torch.tensor([bl], device=x.device), axis, mesh=mesh)
    if bool((rows != bl).any()):
        raise ValueError(f"batch {int(rows.sum())} not divisible by ep={ep}: "
                         f"the ranks hold {rows.tolist()} rows")
    G = bl * S
    Cl = capacity(cfg, G)  # per-device per-expert capacity
    xf = x.reshape(G, D)
    topk_idx, gate, pos, keep, probs, oh = _route(xf, moe, cfg, Cl)
    dt = cfg.dtype
    kept = keep > 0
    eidx = topk_idx.reshape(G * k)
    # Local scatter into [E, Cl, D] (every expert, local tokens).
    send = _scatter(xf, eidx, pos, kept, Cl, E, dt).reshape(
        ep, e_local, Cl, D)
    # Exchange: rank j gets its experts' rows from every rank, stacked by
    # source: [ep (source), e_local, Cl, D].
    recv = C.all_to_all_grad(send, axis, mesh=mesh, split_axis=0,
                             concat_axis=0)
    expert_in = recv.permute(1, 0, 2, 3).reshape(e_local, ep * Cl, D)
    expert_out = _expert_ffn(expert_in, moe, dt)
    back = expert_out.reshape(e_local, ep, Cl, D).permute(1, 0, 2, 3)
    got = C.all_to_all_grad(back.contiguous(), axis, mesh=mesh,
                            split_axis=0, concat_axis=0).reshape(E, Cl, D)
    y = _combine(got, eidx, pos, kept, gate, k)
    frac = oh.sum(dim=1).mean(dim=0)
    aux = E * (frac * probs.mean(dim=0)).sum()
    aux = C.reduce_from(aux, axis, mesh=mesh) / ep
    return y.reshape(x.shape), aux
