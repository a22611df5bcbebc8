"""Port of GRPO against the JAX package on the CPU, on a tiny f32 Llama
(the JAX GRPO test's shape) with weights carried to JAX through the
numpy bridge (the port's seeded init): ``_completion_logps``,
``_sample`` on JAX's own Gumbel draws (the same tokens), the group
advantages and ``_grpo_loss``, and one ``_grpo_body`` (sampling,
rewards, two epochs of clipped Adam) given JAX's row keys' noise —
params within 1e-5 of JAX's after both epochs.
Also the port's counter-based noise, ``GRPO.train``/``sample``, save and
restore, and the refusals.  Every JAX computation runs in one jitted
program (the ``case`` fixture)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.rllib.algorithms import grpo as jg
from ray_tpu.rllib.learner import Learner as JLearner
from ray_tpu.rllib.learner import LearnerSpec as JLearnerSpec
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.rllib import GRPO, GRPOConfig
from ray_tpu_torch.rllib.algorithms import grpo as tg
from ray_tpu_torch.rllib.learner import Learner, LearnerSpec, adam, trainable

_SHAPE = dict(vocab_size=32, dim=32, n_layers=1, n_heads=2, n_kv_heads=2,
              mlp_dim=64, max_seq_len=32)
J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32, **_SHAPE)
T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32, **_SHAPE)
ST = dict(prompt_len=4, max_new=8, group=8, num_prompts=4, temperature=1.0,
          clip=0.2, kl_coef=0.02, num_epochs=2)
J_ST, T_ST = jg._Static(**ST), tg._Static(**ST)
B, P, N, V = 32, 4, 8, 32
TARGET = 7
# f32 on both sides; XLA and ATen sum in other orders.
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are tiny: one intra-op thread.  A pool of threads a
    worker only contends with the other test workers' (under ``-n 6`` it
    made the port's side of these tests 20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j_reward(prompts, completions):
    return (completions == TARGET).mean(axis=-1).astype(jnp.float32)


def t_reward(prompts, completions):
    return (completions == TARGET).float().mean(-1)


LR = 5e-3
JTX = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))


def _jloss(p, b, rng):
    return jg._grpo_loss(p, b["buf"], b["old_logps"], b["ref_logps"],
                         b["adv"], J_CFG, J_ST)


def _loss_case(logps):
    rng = np.random.default_rng(1)
    rewards = rng.random(B).astype(np.float32)
    rewards[8:16] = 0.25  # one group with zero spread
    return {"rewards": rewards,
            "old": logps + rng.normal(0, 0.1, (B, N)).astype(np.float32),
            "ref": logps + rng.normal(0, 0.1, (B, N)).astype(np.float32)}


@pytest.fixture(scope="module")
def case():
    """Weights, prompts, row keys, and in ONE jitted JAX program: the
    noise of those keys, JAX's sample, its completion logps, the group
    advantages and loss, and one ``_grpo_body``."""
    params = bridge.params_to_numpy(tl.init_params(
        torch.Generator().manual_seed(3), T_CFG, device="cpu"))
    prompts = np.random.default_rng(0).integers(0, V, (4, P)).astype(
        np.int32).repeat(8, axis=0)
    ref = jax.tree.map(lambda x: x * 1.01, params)
    # The loss case's logps: any (B, N) values; the sampled ones are not
    # known before the program runs.
    loss_case = _loss_case(np.full((B, N), -3.0, np.float32))

    def program(params, ref, prompts, loss_case):
        row_keys = jax.random.split(jax.random.PRNGKey(5), B)
        noise = jax.vmap(lambda t: jax.vmap(lambda rk: jax.random.gumbel(
            jax.random.fold_in(rk, t), (V,), jnp.float32))(row_keys))(
            jnp.arange(N))
        step0 = jax.vmap(lambda rk: jax.random.categorical(
            jax.random.fold_in(rk, 0), jnp.zeros((V,))))(row_keys)
        buf, logps = jg._sample(params, prompts, row_keys, J_CFG, J_ST)
        grp = loss_case["rewards"].reshape(-1, 8)
        adv = ((grp - grp.mean(axis=1, keepdims=True))
               / (grp.std(axis=1, keepdims=True) + 1e-6)).reshape(-1)
        learner = JLearner(JLearnerSpec(loss_fn=_jloss, optimizer=JTX))
        return {"noise": noise, "step0": step0, "buf": buf, "logps": logps,
                "logps_t07": jg._completion_logps(params, buf, J_CFG, P, N,
                                                  0.7),
                "adv": adv,
                "loss": jg._grpo_loss(params, buf, loss_case["old"],
                                      loss_case["ref"], adv, J_CFG, J_ST),
                "body": jg._grpo_body(J_CFG, learner, j_reward, J_ST, None,
                                      params, ref, JTX.init(params),
                                      prompts, row_keys)}

    out = jax.jit(program)(params, ref, prompts, loss_case)
    return {"params": params, "ref": ref, "prompts": prompts,
            "loss_case": loss_case,
            **{k: jax.tree.map(np.asarray, v) for k, v in out.items()}}


def _tp(params):
    return bridge.params_from_jax(params, device="cpu")


def _noise(case):
    return lambda t: torch.tensor(case["noise"][t])


def test_sample_with_jax_noise_gives_jax_tokens(case):
    # The injected draws are JAX's: argmax(logits + gumbel) is what
    # jax.random.categorical computes.
    assert np.array_equal(case["step0"], np.argmax(case["noise"][0], -1))
    buf, logps = tg._sample(_tp(case["params"]), torch.from_numpy(
        case["prompts"]), T_CFG, T_ST, _noise(case))
    np.testing.assert_array_equal(buf.numpy(), case["buf"])
    np.testing.assert_allclose(logps.numpy(), case["logps"], rtol=0,
                               atol=TOL)


def test_completion_logps_match_jax(case):
    got = tg._completion_logps(_tp(case["params"]),
                               torch.from_numpy(case["buf"]), T_CFG, P, N,
                               0.7)
    np.testing.assert_allclose(got.numpy(), case["logps_t07"], rtol=0,
                               atol=TOL)


def test_advantages_and_loss_match_jax(case):
    lc = case["loss_case"]
    adv = tg.group_advantages(torch.from_numpy(lc["rewards"]), 8)
    np.testing.assert_allclose(adv.numpy(), case["adv"], rtol=0, atol=1e-6)
    jloss, jaux = case["loss"]
    tloss, taux = tg._grpo_loss(_tp(case["params"]),
                                torch.from_numpy(case["buf"]),
                                torch.from_numpy(lc["old"]),
                                torch.from_numpy(lc["ref"]), adv, T_CFG, T_ST)
    assert abs(float(tloss) - float(jloss)) <= TOL
    for k in ("kl", "ratio_mean"):
        assert abs(float(taux[k]) - float(jaux[k])) <= TOL, k


def test_grpo_body_matches_jax_after_two_epochs(case):
    """Sampling, rewards, advantages, reference logps and two epochs of
    clip + Adam, from JAX's row keys (the port on their noise)."""
    jparams, jopt, jm = case["body"]
    tx = adam(LR, 1.0)
    params = trainable(_tp(case["params"]))
    learner = Learner(LearnerSpec(
        loss_fn=lambda p, b, rng: tg._grpo_loss(
            p, b["buf"], b["old_logps"], b["ref_logps"], b["adv"], T_CFG,
            T_ST), optimizer=tx))
    params, opt, tm = tg._grpo_body(
        T_CFG, learner, t_reward, T_ST, params, _tp(case["ref"]),
        tx.init(params), torch.from_numpy(case["prompts"]), _noise(case))
    for k in ("reward_mean", "reward_max", "loss", "kl"):
        assert abs(float(tm[k]) - float(jm[k])) <= TOL, (k, tm[k], jm[k])
    assert tm["logp_gap"] <= TOL and abs(float(tm["ratio_mean"]) - 1) <= TOL
    got = bridge.params_to_numpy(params)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jparams),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TOL,
                                   err_msg=str(path))
    back = bridge.opt_state_to_numpy(opt)
    assert back["count"] == 2 == int(jopt[1][0].count)
    for a, b in zip(jax.tree.leaves(back["mu"]),
                    jax.tree.leaves(jopt[1][0].mu)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=TOL)


def test_noise_is_a_function_of_seed_row_and_step():
    rows = torch.arange(6)
    a = tg.gumbel_noise(11, rows, 3, 1000)
    assert a.dtype == torch.float32 and a.shape == (6, 1000)
    assert torch.equal(a[2:4], tg.gumbel_noise(11, rows[2:4], 3, 1000))
    assert not torch.equal(a, tg.gumbel_noise(11, rows, 4, 1000))
    assert not torch.equal(a, tg.gumbel_noise(12, rows, 3, 1000))
    assert not torch.equal(a[0], a[1])
    # Standard Gumbel: mean = Euler's gamma, variance pi^2 / 6.
    g = tg.gumbel_noise(0, torch.arange(64), 0, 4096).double()
    assert abs(g.mean().item() - 0.5772) < 0.01
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.03


def _config(**kw):
    cfg = GRPOConfig()
    cfg.model = T_CFG
    cfg.reward_fn = t_reward
    cfg.prompt_len, cfg.max_new_tokens = P, N
    cfg.lr, cfg.kl_coef = 5e-3, 0.001
    cfg.device = "cpu"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_train_sample_save_restore_and_refusals(tmp_path):
    algo = GRPO(config=_config())
    m = algo.train()
    assert m["ratio_mean"] == pytest.approx(1.0, abs=1e-6)
    assert m["kl"] >= 0 and m["timesteps_total"] == 4 * 8 * N
    prompts = np.zeros((3, P), np.int32)
    out = algo.sample(prompts, seed=4)
    assert out.shape == (3, N) and torch.equal(out, algo.sample(prompts, 4))
    path = algo.save(str(tmp_path / "grpo.pkl"))
    back = GRPO.from_checkpoint(path, config=_config())
    assert back.iteration == 1
    assert torch.equal(back.sample(prompts, seed=4), out)
    with pytest.raises(ValueError, match="reward_fn"):
        GRPO(config=_config(reward_fn=None))
    with pytest.raises(NotImplementedError, match="multi-device"):
        GRPO(config=_config(num_learners=2))
    with pytest.raises(ValueError, match="prompt_len"):
        algo.sample(np.zeros((2, P + 1), np.int32))
