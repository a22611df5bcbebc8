"""Mixtral over ranks against the JAX package on the CPU: the data-parallel
step's global routing (``models/mixtral.py`` under the ``"global"`` loss
split), expert parallelism in the trainer (``MeshSpec.ep``, each rank
its E/ep experts) and the explicit all-to-all op
(``ray_tpu_torch.ops.moe_a2a.moe_block_ep``), at ``MIXTRAL_TINY`` in f32.

The port runs on a gloo process group of 4 spawned ranks (one launch for
the file, ``tests/torch_dist_cases.py``); the JAX package trains from
the same weights on the same numpy batches with a ``JaxTrainer`` over 4
CPU devices while the ranks run.  Under GSPMD a configuration's result
does not depend on its mesh, ZeRO or dispatch mode, so JAX trains two
references (``MOE_REFS``, one compile each): dp=2 x fsdp=2 (scatter,
ZeRO, grad_accum 2, a loss mask) and dp=2 x ep=2 (scatter, ZeRO).  Each
of the port's cases is held against the one that shares its batches,
grad_accum and capacity: dp=2 x fsdp=2 scatter with ZeRO and dense
without, dp=2 x ep=2 scatter with ZeRO, and fsdp=2 x ep=2 dense without
ZeRO (params split at rest, replicated moments, experts over ep).  Held
per case: each step's loss, cross-entropy, aux loss, grad norm and token
count, and every rank's shard of the final params against the same
slice of JAX's.  The capacity factor 0.5 drops assignments, so the
global capacity and the global buffer positions decide which ones.  The
ranks sum in other orders than XLA: f32 losses and aux losses agree to
2e-6 of their size and grad norms to 1e-5 (the aux loss's router grads
are sums of many small products); params to ``test_torch_zero.py``'s
1e-6 plus 1e-4 of their size.

``moe_block_ep`` at ep 2 (with drops) and 4 (none) against JAX's
``moe_block_ep`` under ``shard_map``: the output and the aux to 1e-5,
and the grads of the loss sum(out * ct) + 0.5 aux (``jax.grad``) for the
rows, the experts and the router (the ranks' shares summed) to 1e-5
plus 1e-4 of their size.  The trainer's ep block against the whole
block on one rank's rows, both dispatch modes: the same to 1e-5.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from ray_tpu.models import mixtral as jm
from ray_tpu.ops.moe_a2a import moe_block_ep as j_moe_block_ep
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.train import JaxTrainer
from ray_tpu.train import RunConfig as JRunConfig
from ray_tpu.train import ScalingConfig as JScalingConfig
from ray_tpu.train import TrainerConfig as JTrainerConfig
from ray_tpu.train import default_optimizer as j_default_optimizer
from ray_tpu_torch import bridge
from ray_tpu_torch.train import backend

import torch_dist_cases as cases

J_CFG = dataclasses.replace(jm.MIXTRAL_TINY, dtype=jnp.float32,
                            capacity_factor=cases.M_CFG.capacity_factor)
WORLD = 4
LOSS_RTOL, GNORM_RTOL = 2e-6, 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-4
A2A_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def np_params():
    """The port's seeded init as numpy, the tree both packages train."""
    import torch

    from ray_tpu_torch.models import mixtral as tmix

    return bridge.params_to_numpy(tmix.init_params(
        torch.Generator().manual_seed(0), cases.M_CFG, device="cpu"))


def _a2a_inputs():
    rng = np.random.default_rng(7)
    shape = (cases.A2A_B, cases.A2A_S, J_CFG.dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _jax_run(case, np_params, devices):
    cfg = dataclasses.replace(J_CFG, dispatch_mode=case.mode)
    axes = {"tokens": ("batch", None)}
    if case.mask:
        axes["loss_mask"] = ("batch", None)
    jt = JaxTrainer(
        init_params=lambda r: jax.tree.map(jnp.asarray, np_params),
        loss_fn=lambda p, b: jm.loss_fn(p, b, cfg),
        params_axes=jm.logical_axes(cfg), batch_axes=axes,
        optimizer=j_default_optimizer(cases.LR, warmup_steps=cases.WARMUP),
        scaling_config=JScalingConfig(
            mesh_spec=JMeshSpec(**case.mesh_kw()), devices=devices),
        run_config=JRunConfig(report_every=1),
        trainer_config=JTrainerConfig(zero_sharding=case.zero,
                                      grad_accum=case.grad_accum))
    res = jt.fit(cases.moe_batches(case), num_steps=cases.STEPS)
    assert res.error is None, res.error
    return {"history": res.metrics_history,
            "params": jax.tree.map(np.asarray, jt.state.params)}


def _jax_a2a(np_moe, x, ct, devices):
    """JAX's moe_block_ep and its grads for each case, one jit each."""
    out = {}
    for name, (mesh_kw, cf) in cases.A2A_CASES.items():
        kw = dict(mesh_kw)
        mesh = JMesh(np.array(devices).reshape(kw["dp"], kw["ep"]),
                     ("dp", "ep"))
        cfg = dataclasses.replace(J_CFG, capacity_factor=cf)

        def loss(x, moe):
            y, aux = j_moe_block_ep(x, moe, cfg, mesh=mesh)
            return (y * ct).sum() + cases.AUX_WEIGHT * aux, (y, aux)

        (_, (y, aux)), (gx, gmoe) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
                jnp.asarray(x), jax.tree.map(jnp.asarray, np_moe))
        out[name] = {"y": np.asarray(y), "aux": float(aux),
                     "x_grad": np.asarray(gx),
                     **{k: np.asarray(v) for k, v in gmoe.items()}}
    return out


@pytest.fixture(scope="module")
def runs(np_params, cpu_devices, tmp_path_factory):
    """(port results per rank, JAX results); the 4 ranks run while JAX
    compiles and trains."""
    root = str(tmp_path_factory.mktemp("ep_ckpt"))
    np_moe = {k: v[0] for k, v in np_params["layers"]["moe"].items()}
    x, ct = _a2a_inputs()
    got = {}

    def port():
        try:
            got["ranks"] = backend.launch(
                cases.moe_ep_rank, WORLD, ["cpu"],
                args=(np_params, np_moe, x, ct, root), timeout_s=240)
        except BaseException as e:  # reported below
            got["error"] = e

    t = threading.Thread(target=port)
    t.start()
    devices = cpu_devices[:WORLD]
    want = {name: _jax_run(case, np_params, devices)
            for name, case in cases.MOE_REFS.items()}
    want["a2a"] = _jax_a2a(np_moe, x, ct, devices)
    t.join(timeout=270)
    assert not t.is_alive(), "the ranks did not finish"
    if "error" in got:
        raise got["error"]
    return got["ranks"], want


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def test_cases_match_their_reference_in_batches_and_grad_accum():
    for name, case in cases.MOE_CASES.items():
        ref = cases.MOE_REFS[case.ref]
        assert (case.mask, case.grad_accum) == (ref.mask, ref.grad_accum), \
            name


@pytest.mark.parametrize("name", list(cases.MOE_CASES))
def test_losses_aux_and_grad_norms_match_jax(runs, name):
    ranks, want = runs
    w = want[cases.MOE_CASES[name].ref]["history"]
    for r, rank in enumerate(ranks):
        got = rank[name]["history"]
        assert len(got) == len(w) == cases.STEPS
        for key in ("loss", "ce_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(
                [m[key] for m in got], [float(m[key]) for m in w],
                rtol=GNORM_RTOL if key == "grad_norm" else LOSS_RTOL,
                err_msg=f"rank {r} {key}")
        # ntokens: the global count of the last microbatch, as JAX's.
        assert [m["ntokens"] for m in got] == \
            [float(m["ntokens"]) for m in w]


@pytest.mark.parametrize("name", list(cases.MOE_CASES))
def test_final_param_shards_match_jax(runs, name):
    ranks, want = runs
    full = _leaves(want[cases.MOE_CASES[name].ref]["params"])
    for r, rank in enumerate(ranks):
        got = _leaves(rank[name]["params"])
        assert sorted(got) == sorted(full)
        for key, shard in got.items():
            sl = tuple(slice(a, b) for a, b in rank[name]["slices"][key])
            np.testing.assert_allclose(shard, full[key][sl], atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL,
                                       err_msg=f"{name} rank {r} {key}")


def test_each_rank_holds_its_experts_at_rest(runs):
    """At dp=2 x ep=2 rank r (dp r // 2, ep r % 2) holds experts [2 (r %
    2), 2 (r % 2) + 2) of each expert leaf and those columns of the
    router, as the JAX package lays them out; ZeRO shards the moments
    over dp inside each ep coordinate."""
    ranks, _ = runs
    E = J_CFG.n_experts
    name = "dp2_ep2_scatter_zero"
    for r, rank in enumerate(ranks):
        rec = rank[name]
        e = r % 2
        for leaf, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 1),
                          ("w_router", 2)):
            key = f"layers.moe.{leaf}"
            assert rec["params"]["layers"]["moe"][leaf].shape[dim] == E // 2
            assert rec["slices"][key][dim] == (e * E // 2, (e + 1) * E // 2)
        b = rec["bytes"]
        assert b["per_device"] < b["global"] / 2


def test_ep_checkpoint_round_trips_and_training_continues(runs):
    ranks, _ = runs
    for r, rank in enumerate(ranks):
        ck = rank["checkpoint"]
        assert ck["step"] == 2 and ck["restored_equal"], r
        assert ck["loss"][0] == ck["loss"][1], r
        assert ck["continued_equal"], r


@pytest.mark.parametrize("mode", ["dense", "scatter"])
def test_moe_block_over_ep_equals_the_whole_block(runs, mode):
    ranks, _ = runs
    E = J_CFG.n_experts
    for r, rank in enumerate(ranks):
        whole, ep = rank["ep_block"][mode]
        e = r % 2
        np.testing.assert_allclose(ep["y"], whole["y"], atol=A2A_TOL,
                                   rtol=A2A_TOL, err_msg=f"rank {r}")
        assert abs(ep["aux"] - whole["aux"]) <= A2A_TOL * whole["aux"]
        np.testing.assert_allclose(ep["x_grad"], whole["x_grad"],
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{r} x_grad")
        mine = slice(e * E // 2, (e + 1) * E // 2)
        for key in ("w_gate", "w_up", "w_down", "w_router"):
            np.testing.assert_allclose(
                ep[key], whole[key][..., mine] if key == "w_router"
                else whole[key][mine],
                atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=f"{r} {key}")


@pytest.mark.parametrize("name", list(cases.A2A_CASES))
def test_moe_block_ep_matches_jax(runs, name):
    """Each rank's rows of the output and of the rows' grads, its experts'
    grads, and the router's grads summed over the ep ranks of dp 0."""
    ranks, want = runs
    w = want["a2a"][name]
    ep = dict(cases.A2A_CASES[name][0])["ep"]
    E, bl = J_CFG.n_experts, cases.A2A_B // ep
    router = 0
    for r, rank in enumerate(ranks):
        got = rank["a2a"][name]
        i = got["ep_index"]
        rows = slice(i * bl, (i + 1) * bl)
        np.testing.assert_allclose(got["y"], w["y"][rows], atol=A2A_TOL,
                                   rtol=A2A_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["aux"], w["aux"], rtol=A2A_TOL)
        np.testing.assert_allclose(got["x_grad"], w["x_grad"][rows],
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"rank {r} x")
        for key in ("w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(
                got[key], w[key][i * E // ep:(i + 1) * E // ep],
                atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=f"rank {r} {key}")
        if r < ep:  # dp 0's ranks: one copy of each rows' share
            router = router + got["w_router"]
    np.testing.assert_allclose(router, w["w_router"], atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)
