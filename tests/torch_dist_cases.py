"""Per-rank bodies of the port's multi-rank CPU tests
(``test_torch_parallel.py``, ``test_torch_zero.py``,
``test_torch_moe_ep.py``, ``test_torch_dp_losses.py``).

``ray_tpu_torch.train.backend.launch`` runs them in spawned processes,
one a rank of a gloo process group; they import torch and the port only
(no jax), and return numpy arrays and plain values to the test, which
holds them against the JAX package run in the test's own process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tpu_torch import bridge, train
from ray_tpu_torch.models import clip as tclip
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import mixtral as tmix
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.ops import moe_a2a
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel import loss_split
from ray_tpu_torch.parallel.mesh import MeshSpec, create_mesh

# --- collectives -------------------------------------------------------------

# (name, fn(x, mesh)) on a dp=2 x fsdp=2 mesh; the test has JAX's twin.
DP_FSDP = ("dp", "fsdp")
COLLECTIVES = {
    "allreduce_sum": lambda x, m: C.allreduce(x, DP_FSDP, mesh=m),
    "allreduce_max_fsdp": lambda x, m: C.allreduce(x, "fsdp", "max", mesh=m),
    "allreduce_min_dp": lambda x, m: C.allreduce(x, "dp", "min", mesh=m),
    "allreduce_mean": lambda x, m: C.allreduce(x, DP_FSDP, "mean", mesh=m),
    "allgather_fsdp": lambda x, m: C.allgather(x, "fsdp", mesh=m),
    "allgather_axis1": lambda x, m: C.allgather(x, DP_FSDP, mesh=m,
                                                tiled_axis=1),
    "reducescatter_fsdp": lambda x, m: C.reducescatter(x, "fsdp", mesh=m),
    "reducescatter_mean": lambda x, m: C.reducescatter(x, DP_FSDP, mesh=m,
                                                       op="mean"),
    "broadcast_dp": lambda x, m: C.broadcast(x, "dp", 1, mesh=m),
    "all_to_all": lambda x, m: C.all_to_all(x, DP_FSDP, mesh=m,
                                            split_axis=0, concat_axis=1),
    "permute": lambda x, m: C.permute(x, DP_FSDP, [(0, 2), (2, 1), (1, 0)],
                                      mesh=m),
    "shift_fsdp": lambda x, m: C.shift(x, "fsdp", mesh=m),
    "shift_back": lambda x, m: C.shift(x, DP_FSDP, -1, mesh=m),
    "send_recv_dp": lambda x, m: C.send_recv(x, "dp", 0, 1, mesh=m),
    "axis_index": lambda x, m: torch.tensor(
        [C.axis_index(DP_FSDP, mesh=m), C.axis_index("fsdp", mesh=m),
         C.axis_size(DP_FSDP, mesh=m), C.axis_size("dp", mesh=m)]),
    "dcn_allreduce_exact": lambda x, m: C.dcn_allreduce(
        x, "dp", mesh=m, quantized=False),
    "quantized_allreduce": lambda x, m: C.quantized_allreduce(
        x, DP_FSDP, mesh=m, chunk=16),
    "dcn_allreduce": lambda x, m: C.dcn_allreduce(x, "fsdp", mesh=m,
                                                  chunk=16),
    "group_allreduce": lambda x, m: C.init_collective_group(
        m, "fsdp", "g").allreduce(x),
}


def collectives_rank(inputs: dict) -> dict:
    """Every collective on this rank's rows of each input (inputs[name]
    is [world, ...]); returns {name: result}."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    mesh = create_mesh(MeshSpec(dp=2, fsdp=2))
    rank = dist.get_rank()
    out = {}
    for name, fn in COLLECTIVES.items():
        x = torch.from_numpy(inputs[name][rank])
        out[name] = fn(x, mesh).numpy()
    return out


# --- training ----------------------------------------------------------------

T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Case:
    """One training configuration, the same on both sides."""

    mesh: tuple = (("dp", 4),)
    zero: bool = False
    int8: bool = False
    grad_accum: int = 1
    mask: bool = False

    def mesh_kw(self) -> dict:
        return dict(self.mesh)


CASES = {
    "fp32": Case(),
    "fp32_zero": Case(zero=True),
    "int8": Case(int8=True),
    "int8_zero": Case(zero=True, int8=True),
    # grad_accum, unequal token counts and a dp x fsdp mesh (params split
    # at rest over fsdp), with the moments replicated and with ZeRO.
    "dp2_fsdp2_accum_mask": Case(mesh=(("dp", 2), ("fsdp", 2)),
                                 grad_accum=2, mask=True),
    "dp2_fsdp2_accum_mask_zero": Case(mesh=(("dp", 2), ("fsdp", 2)),
                                      zero=True, grad_accum=2, mask=True),
}
STEPS = 3
LR, WARMUP = 1e-3, 2


def batches(case: Case, seed: int = 0, B: int = 8, S: int = 32):
    """Global batches from a numpy seed; with ``mask`` a loss mask whose
    rows keep different numbers of tokens, so the ranks' counts differ."""
    rng = np.random.default_rng(seed)
    while True:
        b = {"tokens": rng.integers(0, T_CFG.vocab_size, (B, S))
             .astype(np.int32)}
        if case.mask:
            keep = rng.integers(2, S + 1, (B, 1))
            b["loss_mask"] = (np.arange(S)[None] < keep).astype(np.int32)
        yield b


def optimizer(case: Case):
    if case.int8:
        return train.adamw8bit(LR, warmup_steps=WARMUP,
                               shard_update=case.zero)
    return train.default_optimizer(LR, warmup_steps=WARMUP)


def llama_loss(p, b):
    return tl.loss_fn(p, b, T_CFG)


def whole_batch_loss(p, b):
    """The Llama loss with a term of its own beside its token mean, as
    Mixtral's router aux loss is, that declares no split: not a loss that
    splits by tokens."""
    loss, aux = tl.loss_fn(p, b, T_CFG)
    return loss, dict(aux, aux_loss=torch.zeros_like(loss))


def trainer(case: Case, np_params, loss_fn=llama_loss,
            **run) -> train.TorchTrainer:
    return train.TorchTrainer(
        init_params=lambda g: bridge.params_from_jax(np_params, "cpu"),
        loss_fn=loss_fn,
        params_axes=tl.logical_axes(T_CFG),
        batch_axes={"tokens": ("batch", None), "loss_mask": ("batch", None)},
        optimizer=optimizer(case),
        scaling_config=train.ScalingConfig(
            mesh_spec=MeshSpec(**case.mesh_kw()), devices=["cpu"]),
        run_config=train.RunConfig(report_every=1, **run),
        trainer_config=train.TrainerConfig(zero_sharding=case.zero,
                                           grad_accum=case.grad_accum))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return tree.detach().numpy().copy() if torch.is_tensor(tree) else tree


def run_case(case: Case, np_params) -> dict:
    t = trainer(case, np_params)
    res = t.fit(batches(case), num_steps=STEPS)
    if res.error is not None:
        raise res.error
    sh = t._state_sh
    params = _numpy_tree(t.state.params)
    slices = {}

    def walk(p, s, prefix):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k], f"{prefix}.{k}" if prefix else k)
        else:
            shape = s.global_shape(tuple(p.shape))
            slices[prefix] = [(sl.start, sl.stop)
                              for sl in s.local_slices(shape)]

    walk(t.state.params, sh.params, "")
    return {"history": [{k: m[k] for k in ("loss", "grad_norm", "ntokens")}
                        for m in res.metrics_history],
            "params": params, "slices": slices,
            "bytes": t.opt_state_bytes()}


def _equal_trees(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal_trees(x, y)
                                        for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def checkpoint_case(np_params, root: str) -> dict:
    """A ZeRO int8 run saves its sharded state after 2 steps; a fresh
    trainer restores it (leaves and layouts equal) and both train a
    third step on the same batch, to the same bits."""
    case = CASES["int8_zero"]
    data = batches(case, seed=5)
    first = trainer(case, np_params, storage_path=root, name="z")
    res = first.fit(data, num_steps=2)
    if res.error is not None:
        raise res.error
    second = trainer(case, np_params)
    step = second.restore(res.checkpoint_path)
    restored_equal = (_equal_trees(first.state.params, second.state.params)
                      and _equal_trees(first.state.opt_state,
                                       second.state.opt_state))
    layouts_equal = (repr(first._state_sh.opt_state)
                     == repr(second._state_sh.opt_state))
    nxt = next(data)
    a = first.fit(iter([nxt]), num_steps=1)
    b = second.fit(iter([nxt]), num_steps=1)
    return {"step": step, "restored_equal": restored_equal,
            "layouts_equal": layouts_equal,
            "bytes": second.opt_state_bytes(),
            "loss": (a.metrics["loss"], b.metrics["loss"]),
            "continued_equal": _equal_trees(first.state.params,
                                            second.state.params)}


def refusal_case(np_params) -> dict:
    """A loss that declares no split and does not split by tokens, over 4
    data members: the step raises before its first collective, on every
    rank, and updates nothing."""
    t = trainer(CASES["fp32"], np_params, loss_fn=whole_batch_loss)
    res = t.fit(batches(CASES["fp32"]), num_steps=1)
    return {"error": type(res.error).__name__, "message": str(res.error),
            "step": int(t.state.step)}


def zero_rank(np_params, root: str) -> dict:
    """Every case of ``CASES``, the checkpoint round trip and the
    refusal of a whole-batch loss, on this rank."""
    torch.set_num_threads(1)
    out = {name: run_case(case, np_params) for name, case in CASES.items()}
    out["checkpoint"] = checkpoint_case(np_params, root)
    out["refusal"] = refusal_case(np_params)
    return out


# --- whole-batch losses and expert parallelism ---------------------------------

M_CFG = dataclasses.replace(tmix.MIXTRAL_TINY, dtype=torch.float32,
                            capacity_factor=0.5)


@dataclasses.dataclass(frozen=True)
class MoECase:
    """A Mixtral training configuration; ``ref`` names the JAX run
    (``MOE_REFS``) it is held against."""

    mesh: tuple
    mode: str = "scatter"
    zero: bool = False
    grad_accum: int = 1
    mask: bool = False
    ref: str = ""

    def mesh_kw(self) -> dict:
        return dict(self.mesh)


DP_FSDP2 = (("dp", 2), ("fsdp", 2))
DP_EP2 = (("dp", 2), ("ep", 2))
# The JAX runs, one compile each: under GSPMD a configuration's result
# does not depend on its mesh, ZeRO or dispatch mode (they move only
# roundoff), so each serves the port's cases that share its batches,
# grad_accum and capacity.
MOE_REFS = {
    "dp2_fsdp2": MoECase(DP_FSDP2, "scatter", zero=True, grad_accum=2,
                         mask=True),
    "dp2_ep2": MoECase(DP_EP2, "scatter", zero=True),
}
MOE_CASES = {
    "dp2_fsdp2_scatter_accum_zero": dataclasses.replace(
        MOE_REFS["dp2_fsdp2"], ref="dp2_fsdp2"),
    "dp2_fsdp2_dense_accum": MoECase(DP_FSDP2, "dense", grad_accum=2,
                                     mask=True, ref="dp2_fsdp2"),
    "dp2_ep2_scatter_zero": dataclasses.replace(MOE_REFS["dp2_ep2"],
                                                ref="dp2_ep2"),
    # Params split at rest over fsdp with ZeRO off, experts over ep.
    "fsdp2_ep2_dense": MoECase((("fsdp", 2), ("ep", 2)), "dense",
                               ref="dp2_ep2"),
}
MOE_B, MOE_S = 8, 16
# moe_block_ep: (mesh, capacity factor); at 1.0 some assignments drop, at
# 2.0 (E / k) none does.
A2A_CASES = {"ep2": ((("dp", 2), ("ep", 2)), 1.0),
             "ep4": ((("dp", 1), ("ep", 4)), 2.0)}
A2A_B, A2A_S, AUX_WEIGHT = 8, 8, 0.5


def moe_batches(case: MoECase, seed: int = 0):
    rng = np.random.default_rng(seed)
    while True:
        b = {"tokens": rng.integers(0, M_CFG.vocab_size, (MOE_B, MOE_S))
             .astype(np.int32)}
        if case.mask:
            keep = rng.integers(2, MOE_S + 1, (MOE_B, 1))
            b["loss_mask"] = (np.arange(MOE_S)[None] < keep).astype(np.int32)
        yield b


def moe_cfg(case: MoECase):
    return dataclasses.replace(M_CFG, dispatch_mode=case.mode)


def moe_trainer(case: MoECase, np_params, **run) -> train.TorchTrainer:
    cfg = moe_cfg(case)
    return train.TorchTrainer(
        init_params=lambda g: bridge.params_from_jax(np_params, "cpu"),
        loss_fn=lambda p, b: tmix.loss_fn(p, b, cfg),
        params_axes=tmix.logical_axes(cfg),
        batch_axes={"tokens": ("batch", None), "loss_mask": ("batch", None)},
        optimizer=train.default_optimizer(LR, warmup_steps=WARMUP),
        scaling_config=train.ScalingConfig(
            mesh_spec=MeshSpec(**case.mesh_kw()), devices=["cpu"]),
        run_config=train.RunConfig(report_every=1, **run),
        trainer_config=train.TrainerConfig(zero_sharding=case.zero,
                                           grad_accum=case.grad_accum))


MOE_METRICS = ("loss", "ce_loss", "aux_loss", "grad_norm", "ntokens")


def _fit_record(t, data, keys) -> dict:
    res = t.fit(data, num_steps=STEPS)
    if res.error is not None:
        raise res.error
    params = _numpy_tree(t.state.params)
    slices = {}

    def walk(p, s, prefix):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k], f"{prefix}.{k}" if prefix else k)
        else:
            shape = s.global_shape(tuple(p.shape))
            slices[prefix] = [(sl.start, sl.stop)
                              for sl in s.local_slices(shape)]

    walk(t.state.params, t._state_sh.params, "")
    return {"history": [{k: m[k] for k in keys}
                        for m in res.metrics_history],
            "params": params, "slices": slices,
            "bytes": t.opt_state_bytes()}


def moe_checkpoint_case(np_params, root: str) -> dict:
    """dp=2 x ep=2 with ZeRO: 2 steps saved, restored into a fresh
    trainer (each rank its E/2 experts and its moments' shards), and a
    third step on both from the same batch, to the same bits."""
    case = MOE_CASES["dp2_ep2_scatter_zero"]
    data = moe_batches(case, seed=5)
    first = moe_trainer(case, np_params, storage_path=root, name="ep")
    res = first.fit(data, num_steps=2)
    if res.error is not None:
        raise res.error
    second = moe_trainer(case, np_params)
    step = second.restore(res.checkpoint_path)
    restored = (_equal_trees(first.state.params, second.state.params)
                and _equal_trees(first.state.opt_state,
                                 second.state.opt_state))
    nxt = next(data)
    a = first.fit(iter([nxt]), num_steps=1)
    b = second.fit(iter([nxt]), num_steps=1)
    return {"step": step, "restored_equal": restored,
            "loss": (a.metrics["loss"], b.metrics["loss"]),
            "continued_equal": _equal_trees(first.state.params,
                                            second.state.params)}


def ep_block_case(np_params) -> dict:
    """``moe_block`` over ep=2 (each rank its E/2 experts and router
    columns, the partial outputs summed over ep) against the whole block
    on the same rows,
    both dispatch modes, with drops: the output, the aux and the grads
    of the rows, the router and this rank's experts."""
    import torch.distributed as dist

    mesh = create_mesh(MeshSpec(dp=2, ep=2))
    moe = {k: v[0] for k, v in np_params["layers"]["moe"].items()}
    gen = torch.Generator().manual_seed(dist.get_rank() // 2)
    x = torch.randn((2, MOE_S, M_CFG.dim), generator=gen)
    ct = torch.randn((2, MOE_S, M_CFG.dim), generator=gen)
    group = loss_split.DataGroup(mesh, ("dp",), 1, 0, (0,), 2, 2,
                                 mesh.coords["ep"])
    out = {}
    e, el = mesh.coords["ep"], M_CFG.n_experts // 2
    for mode in ("dense", "scatter"):
        cfg = dataclasses.replace(M_CFG, dispatch_mode=mode)
        runs = []
        for ep in (False, True):
            xs = x.clone().requires_grad_(True)
            if ep:  # the trainer's layout: the router's columns split too
                part = bridge.experts_from_jax(moe, e, 2, "cpu")
                part["w_router"] = part["w_router"][
                    :, e * el:(e + 1) * el].contiguous()
            else:
                part = bridge.params_from_jax(moe, "cpu")
            for v in part.values():
                v.requires_grad_(True)
            if ep:
                with loss_split.publish(group):
                    y, aux = tmix.moe_block(xs, part, cfg)
                    ((y * ct).sum() + AUX_WEIGHT * aux).backward()
            else:
                y, aux = tmix.moe_block(xs, part, cfg)
                ((y * ct).sum() + AUX_WEIGHT * aux).backward()
            runs.append({"y": y.detach().numpy(), "aux": aux.item(),
                         "x_grad": xs.grad.numpy(),
                         **{k: v.grad.numpy() for k, v in part.items()}})
        out[mode] = runs
    return out


def a2a_rank(np_moe, x, ct) -> dict:
    """``moe_block_ep`` on this rank: its rows of ``x`` over ep, its
    experts; the loss sum(y * ct) + AUX_WEIGHT * aux, its grads."""
    out = {}
    for name, (mesh_kw, cf) in A2A_CASES.items():
        mesh = create_mesh(MeshSpec(**dict(mesh_kw)))
        ep, i = mesh.shape["ep"], mesh.coords["ep"]
        cfg = dataclasses.replace(M_CFG, capacity_factor=cf)
        rows = slice(i * A2A_B // ep, (i + 1) * A2A_B // ep)
        xs = torch.from_numpy(x[rows]).requires_grad_(True)
        moe = bridge.experts_from_jax(np_moe, i, ep, "cpu")
        for v in moe.values():
            v.requires_grad_(True)
        y, aux = moe_a2a.moe_block_ep(xs, moe, cfg, mesh=mesh)
        ((y * torch.from_numpy(ct[rows])).sum()
         + AUX_WEIGHT * aux).backward()
        out[name] = {"ep_index": i, "y": y.detach().numpy(),
                     "aux": aux.item(), "x_grad": xs.grad.numpy(),
                     **{k: v.grad.numpy() for k, v in moe.items()}}
    return out


def moe_ep_rank(np_params, np_moe, x, ct, root: str) -> dict:
    """Every case of ``MOE_CASES``, the ep checkpoint round trip, the ep
    block against the whole block, and ``moe_block_ep``, on this rank."""
    torch.set_num_threads(1)
    out = {name: _fit_record(moe_trainer(case, np_params),
                             moe_batches(case), MOE_METRICS)
           for name, case in MOE_CASES.items()}
    out["checkpoint"] = moe_checkpoint_case(np_params, root)
    out["ep_block"] = ep_block_case(np_params)
    out["a2a"] = a2a_rank(np_moe, x, ct)
    return out


# --- ViT and CLIP over ranks; CLIP's explicit form; autograd collectives ---

V_CFG = dataclasses.replace(tvit.VIT_TINY, dtype=torch.float32)
C_CFG = dataclasses.replace(
    tclip.CLIP_TINY,
    vision=dataclasses.replace(tclip.CLIP_TINY.vision, dtype=torch.float32),
    text=dataclasses.replace(tclip.CLIP_TINY.text, dtype=torch.float32))
FAMILY_RULES = {"patch": None, "classes": None, "qkv": None, "proj": None}
FAMILY_B = 8


def family_batches(family: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    v = V_CFG if family == "vit" else C_CFG.vision
    while True:
        b = {"images": rng.normal(size=(FAMILY_B, v.image_size, v.image_size,
                                        v.channels)).astype(np.float32)}
        if family == "vit":
            b["labels"] = rng.integers(0, V_CFG.num_classes,
                                       (FAMILY_B,)).astype(np.int32)
        else:
            b["tokens"] = rng.integers(1, C_CFG.text.vocab_size,
                                       (FAMILY_B, C_CFG.text.max_len)
                                       ).astype(np.int32)
        yield b


def family_loss(family: str):
    if family == "vit":
        return lambda p, b: (tvit.loss_fn(p, b["images"], b["labels"],
                                          V_CFG), {})
    return lambda p, b: (tclip.contrastive_loss(p, b["images"], b["tokens"],
                                                C_CFG), {})


def family_trainer(family: str, np_params) -> train.TorchTrainer:
    axes = (tvit.logical_axes(V_CFG) if family == "vit"
            else tclip.logical_axes(C_CFG))
    batch_axes = {k: ("batch",) + (None,) * n for k, n in
                  (("images", 3), ("labels", 0), ("tokens", 1))}
    return train.TorchTrainer(
        init_params=lambda g: bridge.params_from_jax(np_params, "cpu"),
        loss_fn=family_loss(family), params_axes=axes, batch_axes=batch_axes,
        rules=FAMILY_RULES,
        optimizer=train.default_optimizer(LR, warmup_steps=WARMUP),
        scaling_config=train.ScalingConfig(
            mesh_spec=MeshSpec(**dict(DP_FSDP2)), devices=["cpu"]),
        run_config=train.RunConfig(report_every=1))


def contrastive_rank(np_params, images, tokens) -> dict:
    """``contrastive_loss(axis_name="dp")`` on this rank's rows over a
    dp=4 mesh: the loss and this rank's grads of every leaf."""
    mesh = create_mesh(MeshSpec(dp=4))
    n, i = mesh.shape["dp"], mesh.coords["dp"]
    rows = slice(i * len(images) // n, (i + 1) * len(images) // n)
    params = bridge.params_from_jax(np_params, "cpu")
    leaves = train.state.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tclip.contrastive_loss(params, torch.from_numpy(images[rows]),
                                  torch.from_numpy(tokens[rows]), C_CFG,
                                  axis_name="dp", mesh=mesh)
    grads = train.step._grad(loss, leaves)
    return {"loss": loss.item(), "grads": _numpy_tree(
        train.step._unflatten_like(params, grads))}


# (name, fn(x, mesh)) of the collectives that carry gradients, on a dp=2 x
# fsdp=2 mesh; the test has JAX's twin.
GRAD_COLLECTIVES = {
    "allgather_grad": lambda x, m: C.allgather_grad(x, DP_FSDP, mesh=m),
    "allgather_grad_axis1": lambda x, m: C.allgather_grad(
        x, "fsdp", mesh=m, tiled_axis=1),
    "all_to_all_grad": lambda x, m: C.all_to_all_grad(
        x, DP_FSDP, mesh=m, split_axis=0, concat_axis=1),
    "copy_to": lambda x, m: C.copy_to(x, "fsdp", mesh=m),
    "reduce_from": lambda x, m: C.reduce_from(x, DP_FSDP, mesh=m),
}


def grad_collectives_rank(inputs: dict) -> dict:
    """Each collective on this rank's ``x`` (inputs[name]["x"][rank]),
    the loss sum(out * ct) with this rank's cotangent; returns {name:
    (out, the grad of x)}."""
    import torch.distributed as dist

    mesh = create_mesh(MeshSpec(dp=2, fsdp=2))
    rank = dist.get_rank()
    out = {}
    for name, fn in GRAD_COLLECTIVES.items():
        x = torch.from_numpy(inputs[name]["x"][rank]).requires_grad_(True)
        y = fn(x, mesh)
        (y * torch.from_numpy(inputs[name]["ct"][rank])).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    out["gather_from"] = gather_from_case(mesh, rank)
    return out


def gather_from_case(mesh, rank: int):
    """``gather_from`` over fsdp of x = 10 rank + [0, 1, 2] (rows of 3),
    the cotangent equal on the dp member's two ranks: (the gathered
    value, the grad of x)."""
    x = (10.0 * rank + torch.arange(3.0))[None].requires_grad_(True)
    ct = torch.arange(6.0).reshape(2, 3) + 100.0 * mesh.coords["dp"]
    y = C.gather_from(x, "fsdp", mesh=mesh)
    (y * ct).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def dp_losses_rank(vit_params, clip_params, images, tokens,
                   coll_inputs) -> dict:
    """ViT and CLIP trained over dp=2 x fsdp=2, CLIP's explicit form over
    dp=4, and the autograd collectives, on this rank."""
    torch.set_num_threads(1)
    out = {f: _fit_record(family_trainer(f, p), family_batches(f),
                          ("loss", "grad_norm"))
           for f, p in (("vit", vit_params), ("clip", clip_params))}
    out["contrastive"] = contrastive_rank(clip_params, images, tokens)
    out["collectives"] = grad_collectives_rank(coll_inputs)
    return out
