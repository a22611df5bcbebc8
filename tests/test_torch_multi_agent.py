"""Port of the multi-agent stack against the JAX package on the CPU:
``TwoAgentReach``'s reset on JAX's draws and its step (clipping,
crowding, the time limit), then one ``MultiAgentPPO`` iteration (T 4, N
4, 2 epochs x 2 minibatches, episodes ending inside the window) from one
state — the port's stacked per-agent weights and a non-zero Adam state,
carried into the port through ``bridge.ma_ppo_state_from_jax`` — the
port on JAX's own draws: params, Adam moments, env state, returns and
the per-agent metrics within 1e-5.  Also ``compute_actions`` and a state
round trip.  Every JAX computation of the file runs in one jitted
program (the ``jax_out`` fixture)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import multi_agent as jma
from ray_tpu_torch import bridge
from ray_tpu_torch.rllib import multi_agent as tma

TOL = 1e-5
T, N, A = 4, 4, 2
OPTS = dict(num_epochs=2, num_minibatches=2, hidden=(16,), lr=1e-2)
KEY = 11


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are tiny: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], tol, f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=what)


def _reset_draws(keys):
    """The [0, 1) floats JAX's ``TwoAgentReach.reset(key)`` turns into
    positions and targets: [len(keys), 2, A, 2]."""
    def one(k):
        kp, kt = jax.random.split(k)
        return jnp.stack([jax.random.uniform(kp, (A, 2)),
                          jax.random.uniform(kt, (A, 2))])
    return jax.vmap(one)(keys)


def _jax_draws(key, cfg):
    """The draws of JAX's ``_ma_ppo_iteration`` on ``key``."""
    step_keys = jax.random.split(key, T + 1)

    def step(sk):
        ks = jax.random.split(sk, A + 1)
        return (jax.vmap(lambda k: jax.random.normal(k, (N, 2)))(ks[:A]),
                _reset_draws(jax.random.split(ks[A], N)))

    action, reset = jax.vmap(step)(step_keys[:T])
    perms = jax.vmap(lambda k: jax.random.permutation(k, T * N))(
        jax.random.split(step_keys[T], cfg.num_epochs))
    return {"action": action, "reset": reset, "perms": perms}


def _build(**kw):
    return (tma.MultiAgentPPOConfig().training(**OPTS, **kw)
            .env_runners(num_envs=N, rollout_length=T)
            .resources(device="cpu").build())


def _step_case():
    rng = np.random.default_rng(1)
    state = {"pos": rng.uniform(-1.6, 1.6, (16, A, 2)).astype(np.float32),
             "tgt": rng.uniform(-1, 1, (16, A, 2)).astype(np.float32),
             "t": rng.integers(60, 64, 16).astype(np.int32)}
    state["pos"][:4, 1] = state["pos"][:4, 0] + 0.05   # crowding
    action = rng.uniform(-1.5, 1.5, (16, A, 2)).astype(np.float32)
    return state, action


def _start():
    algo = _build()
    rng = np.random.default_rng(2)
    params = bridge.params_to_numpy(algo.params)
    mu = jax.tree.map(lambda x: rng.normal(0, 0.1, x.shape).astype(
        np.float32), params)
    nu = jax.tree.map(lambda x: rng.uniform(0.01, 0.2, x.shape).astype(
        np.float32), params)
    opt = (optax.ScaleByAdamState(count=np.full(A, 3, np.int32), mu=mu,
                                  nu=nu), optax.EmptyState())
    env_state = _np(algo.env_state)
    env_state["t"][:2] = [61, 62]
    return ({"params": params, "opt_state": opt, "iteration": 0,
             "timesteps_total": 0}, env_state, _np(algo.obs))


@pytest.fixture(scope="module")
def jax_out():
    start = _start()

    def program(start, step_case):
        state, env_state, obs = start
        env = jma.TwoAgentReach()
        cfg = jma.MultiAgentPPOConfig().training(**OPTS).env_runners(
            num_envs=N, rollout_length=T)
        net = jmodels.ActorCritic(env.observation_size, env.action_size,
                                  discrete=False, hidden=cfg.hidden)
        fn = partial(jma._ma_ppo_iteration, env, net, optax.adam(cfg.lr),
                     jma._static_cfg(cfg))
        key = jax.random.PRNGKey(KEY)
        reset_keys = jax.random.split(jax.random.PRNGKey(4), 8)
        return {"iteration": fn(state["params"], state["opt_state"],
                                env_state, obs, jnp.zeros((N, A)), key),
                "draws": _jax_draws(key, cfg),
                "reset": (_reset_draws(reset_keys),
                          jax.vmap(env.reset)(reset_keys)),
                "step": jax.vmap(env.step)(*step_case)}

    return start, jax.jit(program)(start, _step_case())


def test_two_agent_reach_matches_jax(jax_out):
    out = jax_out[1]
    env = tma.TwoAgentReach()
    draws, (jstate, jobs) = out["reset"]
    state, obs = env.reset(torch.from_numpy(np.array(draws)))
    _close([state, obs], [jstate, jobs], 1e-6, "reset")
    assert obs.shape == (8, A, 8)
    s, action = _step_case()
    got = env.step({k: torch.from_numpy(v) for k, v in s.items()},
                   torch.from_numpy(action))
    _close(list(got), list(out["step"]), 1e-6, "step")
    assert got[3].any() and not got[3].all()


def test_iteration_matches_jax(jax_out):
    (state, env_state, obs), out = jax_out
    algo = _build()
    algo.set_state(bridge.ma_ppo_state_from_jax(state, "cpu"))
    for k, v in env_state.items():
        algo.env_state[k].copy_(torch.from_numpy(v))
    algo.obs.copy_(torch.from_numpy(obs))
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in out["draws"].items()}
    opt, m = tma._ma_ppo_iteration(algo.env, algo.net, algo.tx, algo.config,
                                   algo.params, algo.opt_state,
                                   algo.env_state, algo.obs, algo.ep_ret,
                                   draws)
    jparams, jopt, jenv_state, jobs, jret, jm = out["iteration"]
    _close(algo.params, jparams, TOL, "params")
    _close(opt["mu"], jopt[0].mu, TOL, "mu")
    _close(opt["nu"], jopt[0].nu, TOL, "nu")
    assert [opt["count"]] * A == np.asarray(jopt[0].count).tolist() \
        == [3 + 2 * 2] * A
    _close([algo.env_state, algo.obs, algo.ep_ret],
           [jenv_state, jobs, jret], TOL, "env")
    for k, v in jm.items():
        np.testing.assert_allclose(m[k], np.asarray(v), rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert np.isfinite(m["episode_return_mean"]).all()


def test_train_actions_and_state_round_trip():
    algo = _build()
    r = algo.train()
    keys = {"episode_return_mean", "loss", "loss/agent_0", "loss/agent_1",
            "episode_return_mean/agent_0", "episode_return_mean/agent_1"}
    assert keys <= set(r) and r["timesteps_total"] == T * N
    assert all(v.shape[0] == A for v in
               jax.tree.leaves(bridge.params_to_numpy(algo.params)))
    assert not np.allclose(_np(algo.params["pi"]["layers"][0]["w"][0]),
                           _np(algo.params["pi"]["layers"][0]["w"][1]))
    obs = np.zeros((A, 8), np.float32)
    assert algo.compute_actions(obs).shape == (A, 2)
    again = _build(seed=5)
    again.set_state(algo.get_state())
    _close(again.params, algo.params, 0.0, "params")
