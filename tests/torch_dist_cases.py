"""Per-rank bodies of the port's multi-rank CPU tests
(``test_torch_parallel.py``, ``test_torch_zero.py``).

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
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.parallel import collectives as C
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
    Mixtral's router aux loss is: not a loss that splits by tokens."""
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
    """A loss that does not split by tokens, over 4 data members: the
    step raises before its first collective, on every rank, and updates
    nothing."""
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
