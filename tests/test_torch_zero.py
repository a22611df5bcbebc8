"""Data-parallel training and ZeRO-sharded optimizer state
(``ray_tpu_torch.train.zero``, the data-parallel ``train/step.py``)
against the JAX trainer on the CPU, at ``LLAMA_TINY`` in f32.

The port runs on a gloo process group of 4 spawned ranks (one launch
for the file, ``tests/torch_dist_cases.py``); the JAX package trains the
same configurations from the same weights (carried across by
``bridge.params_from_jax``) on the same numpy batches with a
``JaxTrainer`` over 4 CPU devices, each configuration compiled once,
while the ranks run.  Held per configuration: each step's loss and
grad norm, every rank's shard of the final params (against the same
slice of JAX's), the ZeRO layout's per-device bytes of Adam's moments
(equal to JAX's), and the global bytes (equal to the replicated
layout's).  The ranks sum their grads in another order than XLA: f32
losses and grad norms agree to 2e-6 of their size (a few ulps of sums
taken in other orders; 2e-7 seen); params to 1e-6 plus 1e-4 of their
size (3.4e-7 seen), and to 1e-5 plus 1e-3 with int8 moments, whose
re-quantised blocks may land an int8 step apart (1.2e-5 seen).  Over 4
ranks the step refuses a loss that does not split by tokens.  A world
of one rank runs in this process: there the ZeRO step equals the
replicated step bit for bit, and both equal the single-device step of
a trainer without a process group.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.train import JaxTrainer
from ray_tpu.train import RunConfig as JRunConfig
from ray_tpu.train import ScalingConfig as JScalingConfig
from ray_tpu.train import TrainerConfig as JTrainerConfig
from ray_tpu.train import adamw8bit as j_adamw8bit
from ray_tpu.train import default_optimizer as j_default_optimizer
from ray_tpu.train import zero as jzero
from ray_tpu_torch import train
from ray_tpu_torch.parallel import MeshSpec
from ray_tpu_torch.train import backend

import torch_dist_cases as cases

J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
WORLD = 4
LOSS_RTOL = GNORM_RTOL = 2e-6
PARAM_TOL = {False: (1e-6, 1e-4), True: (1e-5, 1e-3)}  # by int8 moments


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray,
                        jl.init_params(jax.random.PRNGKey(0), J_CFG))


def _jax_run(case, np_params, devices):
    axes = {"tokens": ("batch", None)}
    if case.mask:
        axes["loss_mask"] = ("batch", None)
    opt = (j_adamw8bit(cases.LR, warmup_steps=cases.WARMUP,
                       shard_update=case.zero) if case.int8 else
           j_default_optimizer(cases.LR, warmup_steps=cases.WARMUP))
    jt = JaxTrainer(
        init_params=lambda r: jax.tree.map(jnp.asarray, np_params),
        loss_fn=lambda p, b: jl.loss_fn(p, b, J_CFG),
        params_axes=jl.logical_axes(J_CFG), batch_axes=axes, optimizer=opt,
        scaling_config=JScalingConfig(
            mesh_spec=JMeshSpec(**case.mesh_kw()), devices=devices),
        run_config=JRunConfig(report_every=1),
        trainer_config=JTrainerConfig(zero_sharding=case.zero,
                                      grad_accum=case.grad_accum))
    res = jt.fit(cases.batches(case), num_steps=cases.STEPS)
    assert res.error is None, res.error
    moments = next(n for n in jax.tree.leaves(
        jt.state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(n, "mu"))
    return {"history": res.metrics_history,
            "params": jax.tree.map(np.asarray, jt.state.params),
            "bytes": jzero.opt_state_bytes((moments.mu, moments.nu))}


@pytest.fixture(scope="module")
def runs(np_params, cpu_devices, tmp_path_factory):
    """(port results per rank, JAX results) for every case; the 4 ranks
    run while JAX compiles and trains."""
    root = str(tmp_path_factory.mktemp("zero_ckpt"))
    got = {}

    def port():
        try:
            got["ranks"] = backend.launch(
                cases.zero_rank, WORLD, ["cpu"], args=(np_params, root),
                timeout_s=300)
        except BaseException as e:  # reported by the fixture below
            got["error"] = e

    t = threading.Thread(target=port)
    t.start()
    want = {name: _jax_run(case, np_params, cpu_devices[:WORLD])
            for name, case in cases.CASES.items()}
    t.join(timeout=330)
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


@pytest.mark.parametrize("name", list(cases.CASES))
def test_losses_and_grad_norms_match_jax(runs, name):
    ranks, want = runs
    w = want[name]["history"]
    for r, rank in enumerate(ranks):
        got = rank[name]["history"]
        assert len(got) == len(w) == cases.STEPS
        np.testing.assert_allclose([m["loss"] for m in got],
                                   [float(m["loss"]) for m in w],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose([m["grad_norm"] for m in got],
                                   [float(m["grad_norm"]) for m in w],
                                   rtol=GNORM_RTOL, err_msg=f"rank {r}")
        # ntokens: the global count of the last microbatch, as JAX's.
        assert [m["ntokens"] for m in got] == \
            [float(m["ntokens"]) for m in w]


@pytest.mark.parametrize("name", list(cases.CASES))
def test_final_param_shards_match_jax(runs, name):
    ranks, want = runs
    atol, rtol = PARAM_TOL[cases.CASES[name].int8]
    full = _leaves(want[name]["params"])
    for r, rank in enumerate(ranks):
        got = _leaves(rank[name]["params"])
        assert sorted(got) == sorted(full)
        for key, shard in got.items():
            sl = tuple(slice(a, b) for a, b in rank[name]["slices"][key])
            np.testing.assert_allclose(shard, full[key][sl], atol=atol,
                                       rtol=rtol,
                                       err_msg=f"{name} rank {r} {key}")


@pytest.mark.parametrize("name", ["fp32_zero", "int8_zero",
                                  "dp2_fsdp2_accum_mask_zero"])
def test_zero_bytes_match_jax(runs, name):
    """Each rank holds JAX's per-device share of Adam's moments; the
    global bytes equal the replicated layout's."""
    ranks, want = runs
    base = "int8" if cases.CASES[name].int8 else "fp32"
    for rank in ranks:
        b = rank[name]["bytes"]
        assert b["per_device"] == want[name]["bytes"]["per_device"]
        assert b["global"] == want[name]["bytes"]["global"]
        assert b["global"] == rank[base]["bytes"]["global"] \
            == rank[base]["bytes"]["per_device"]
        assert b["per_device"] < b["global"] / 2


def test_sharded_checkpoint_round_trips_and_training_continues(runs):
    ranks, _ = runs
    for r, rank in enumerate(ranks):
        ck = rank["checkpoint"]
        assert ck["step"] == 2, r
        assert ck["restored_equal"] and ck["layouts_equal"], r
        assert ck["bytes"] == rank["int8_zero"]["bytes"], r
        assert ck["loss"][0] == ck["loss"][1], r
        assert ck["continued_equal"], r


def test_data_parallel_step_refuses_a_loss_that_does_not_split(runs):
    """A loss that declares no split and whose aux is not a token split's
    is refused over several members; the message names the protocol."""
    ranks, _ = runs
    for r, rank in enumerate(ranks):
        ref = rank["refusal"]
        assert ref["error"] == "NotImplementedError", (r, ref)
        assert "loss_split.declare" in ref["message"], (r, ref)
        assert "aux_loss" in ref["message"], (r, ref)
        assert ref["step"] == 0, (r, ref)


# --- a world of one rank, in this process ------------------------------------

def _fit_one_rank(np_params, int8, zero, loss_fn=cases.llama_loss):
    case = cases.Case(mesh=(("dp", 1),), zero=zero, int8=int8)
    t = cases.trainer(case, np_params, loss_fn=loss_fn)
    res = t.fit(cases.batches(case, seed=3), num_steps=cases.STEPS)
    assert res.error is None, res.error
    return t, res


def _equal(a, b):
    if isinstance(a, dict):
        return all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


@pytest.mark.parametrize("int8", [False, True])
def test_zero_equals_replicated_bit_for_bit_on_one_rank(np_params, int8):
    # One thread: the CPU's threaded reductions may split sums differently
    # from one run to the next, and this compares two runs' bits.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    backend.init_process_group(0, 1, device="cpu")
    try:
        base, rb = _fit_one_rank(np_params, int8, zero=False)
        shrd, rs = _fit_one_rank(np_params, int8, zero=True)
        assert [m["loss"] for m in rs.metrics_history] == \
            [m["loss"] for m in rb.metrics_history]
        assert [m["grad_norm"] for m in rs.metrics_history] == \
            [m["grad_norm"] for m in rb.metrics_history]
        assert _equal(shrd.state.params, base.state.params)
        assert _equal(shrd.state.opt_state, base.state.opt_state)
        assert shrd.opt_state_bytes() == base.opt_state_bytes()
        assert train.zero.dp_shards(shrd.mesh) == 1
        # One data member takes a loss that does not split by tokens.
        _, rw = _fit_one_rank(np_params, int8, zero=True,
                              loss_fn=cases.whole_batch_loss)
        assert [m["loss"] for m in rw.metrics_history] == \
            [m["loss"] for m in rs.metrics_history]
        # Without a process group the trainer refuses ZeRO and
        # shard_update, and runs the single-device step: the same bits.
        backend.shutdown()
        with pytest.raises(NotImplementedError, match="process group"):
            _fit_one_rank(np_params, int8, zero=True)
        plain, rp = _fit_one_rank(np_params, int8, zero=False)
        assert plain._layout is None and shrd._layout is not None
        for key in ("loss", "grad_norm"):
            assert [m[key] for m in rp.metrics_history] == \
                [m[key] for m in rs.metrics_history], key
        assert _equal(plain.state.params, shrd.state.params)
        assert _equal(plain.state.opt_state, shrd.state.opt_state)
    finally:
        backend.shutdown()
        torch.set_num_threads(threads)


def test_trainer_refuses_a_group_of_another_backend(np_params,
                                                    monkeypatch):
    """A rank on the CPU in a group whose collectives take card tensors
    (NCCL) raises before it builds anything."""
    import torch.distributed as dist

    backend.init_process_group(0, 1, device="cpu")
    try:
        monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
        t = cases.trainer(cases.Case(mesh=(("dp", 1),)), np_params)
        with pytest.raises(ValueError, match="gloo process group"):
            t.state
    finally:
        monkeypatch.undo()
        backend.shutdown()


def test_batch_rows_follow_jax_sharding_under_grad_accum():
    """Rank r's rows of microbatch i are chunk r of that microbatch."""
    rows = np.arange(16)[:, None].repeat(3, 1)
    for k in (1, 2):
        t = object.__new__(train.TorchTrainer)
        t.batch_axes, t.rules = None, None
        t.trainer_config = train.TrainerConfig(grad_accum=k)
        seen = []
        for rank in range(4):
            t.mesh = train.trainer.create_mesh(MeshSpec(dp=2, fsdp=2),
                                               world_size=4, rank=rank)
            got = t._rows("tokens", torch.from_numpy(rows))[:, 0].tolist()
            seen.append(got)
            micro = np.split(np.arange(16), k)
            assert got == [x for m in micro
                           for x in np.split(m, 4)[rank].tolist()]
        assert sorted(sum(seen, [])) == list(range(16))


def test_refusals_name_their_roadmap_item():
    for axis, item in (("tp", "item 6 part 3"), ("dcn_tp", "item 6 part 3"),
                       ("sp", "item 7"), ("pp", "item 7"),
                       ("dcn_pp", "item 7")):
        with pytest.raises(NotImplementedError, match=item):
            train.ScalingConfig(mesh_spec=MeshSpec(**{axis: 2}),
                                devices=["cpu"]).device()
    # ep is a mesh axis the trainer takes (tests/test_torch_moe_ep.py):
    # without a process group of that size it asks for one.
    with pytest.raises(NotImplementedError, match="process group") as e:
        train.ScalingConfig(mesh_spec=MeshSpec(ep=2),
                            devices=["cpu"]).device()
    assert "item" not in str(e.value)
    with pytest.raises(NotImplementedError, match="zero_sharding"):
        train.compile_train_step(lambda p, b: None, train.default_optimizer(),
                                 zero_sharding=True)
