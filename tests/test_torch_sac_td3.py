"""Port of SAC, TD3 and DDPG against the JAX package on the CPU: one
iteration of a few env steps (squashed-Gaussian or noisy deterministic
acting, warm-up uniforms, buffer writes that wrap, episodes that end at
the time limit, updates that start inside the window, every other step
with ``train_freq`` 2, the actor every other update with ``policy_delay``
2) from one state — the port's weights, a non-zero Adam state and
targets apart from the params, carried into the port through the
``bridge`` functions — the port on JAX's own draws: params, targets, Adam
moments, the buffer, the env and the metrics within 1e-5.  Also state
round trips and the refusals.  Every JAX iteration of the file, and the
draws it makes, runs in one jitted program (the ``jax_out`` fixture)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import replay_buffer as jrb
from ray_tpu.rllib.algorithms import ddpg as jddpg
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.algorithms import td3 as jtd3
from ray_tpu_torch import bridge
from ray_tpu_torch.rllib.algorithms import ddpg as tddpg
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.algorithms import td3 as ttd3

TOL = 1e-5
T, N, BATCH, CAP, STARTS = 6, 4, 8, 16, 12
COMMON = dict(num_envs=N, steps_per_iteration=T, learning_starts=STARTS,
              train_batch_size=BATCH, buffer_capacity=CAP, hidden=(16,),
              lr=1e-2)
CASES = {  # name: (JAX module, port module, config module name, options)
    "sac": (jsac, tsac, "SACConfig", {}),
    "sac_train_freq2": (jsac, tsac, "SACConfig", dict(train_freq=2)),
    "td3": (jtd3, ttd3, "TD3Config", dict(policy_delay=2)),
    "ddpg": (jddpg, tddpg, "DDPGConfig", {}),
}
SPECS = {"obs": ((3,), jnp.float32), "action": ((1,), jnp.float32),
         "reward": ((), jnp.float32), "next_obs": ((3,), jnp.float32),
         "done": ((), jnp.float32)}
KEY = 7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are tiny: one intra-op thread.  A pool of threads a
    worker only contends with the other test workers'."""
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


def _config(mod, case):
    _, _, name, kw = CASES[case]
    return getattr(mod, name)().training(**COMMON, **kw)


def _adam_chain(tree, count, rng):
    """An optax Adam state over ``tree`` with moments drawn from ``rng``
    (``nu`` positive), as numpy."""
    mu = jax.tree.map(lambda x: rng.normal(0, 0.1, x.shape).astype(
        np.float32), tree)
    nu = jax.tree.map(lambda x: rng.uniform(0.01, 0.2, x.shape).astype(
        np.float32), tree)
    return (optax.ScaleByAdamState(count=np.int32(count), mu=mu, nu=nu),
            optax.EmptyState())


def _start(case):
    """The JAX-format start state of ``case``: the port's seeded weights,
    targets a little apart from them, a non-zero Adam state, and env
    states of which two end at the time limit inside the window."""
    _, tmod, _, _ = CASES[case]
    algo = getattr(tmod, CASES[case][2])(
        ).training(**COMMON, **CASES[case][3]).resources(device="cpu").build()
    rng = np.random.default_rng(len(case))
    params = bridge.params_to_numpy(algo.params)
    sac = case.startswith("sac")
    tgt_keys = ("q1", "q2") if sac else tuple(params)
    target = {k: jax.tree.map(lambda x: x + rng.normal(0, 0.01, x.shape)
                              .astype(np.float32), params[k])
              for k in tgt_keys}
    if sac:
        opt = _adam_chain(params, 3, rng)
    else:
        critics = {k: v for k, v in params.items() if k != "actor"}
        opt = (_adam_chain(params["actor"], 2, rng),
               _adam_chain(critics, 3, rng))
    env_state = _np(algo.env_state)
    env_state["t"][:2] = [197, 198]
    return {"params": params, "target_q" if sac else "target": target,
            "opt_state": opt, "iteration": 0, "timesteps_total": 0,
            "total_env_steps": 0}, env_state, _np(algo.obs)


def _pendulum_resets(keys):
    def one(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k1, ()),
                          jax.random.uniform(k2, ())])
    return jax.vmap(one)(keys)


def _sample_draw(k, filled):
    """The buffer's slot indices of ``jax.random.randint`` as the [0, 1)
    draws the port turns back into them."""
    idx = jax.random.randint(k, (BATCH,), 0, jnp.maximum(filled, 1))
    return (idx + 0.5) / filled


def _jax_draws(key, sac):
    """The draws of JAX's ``_sac_iteration`` / ``_td3_iteration`` on
    ``key``."""

    def step(sk, filled):
        if sac:
            k_act, k_reset, k_sample, k_loss = jax.random.split(sk, 4)
            k1, k2 = jax.random.split(k_loss)
            return {
                "action": jax.vmap(lambda k: jax.random.normal(k, (1, 1))[0]
                                   )(jax.random.split(k_act, N)),
                "reset": _pendulum_resets(jax.random.split(k_reset, N)),
                "sample": _sample_draw(k_sample, filled),
                "loss": jnp.stack([jax.random.normal(k1, (BATCH, 1)),
                                   jax.random.normal(k2, (BATCH, 1))])}
        k_act, k_warm, k_reset, k_sample, k_loss = jax.random.split(sk, 5)
        return {"explore": jax.random.normal(k_act, (N, 1)),
                "warm": jax.random.uniform(k_warm, (N, 1)),
                "reset": _pendulum_resets(jax.random.split(k_reset, N)),
                "sample": _sample_draw(k_sample, filled),
                "target": jax.random.normal(k_loss, (BATCH, 1))}

    filled = np.minimum(np.arange(1, T + 1) * N, CAP)
    return jax.vmap(step)(jax.random.split(key, T), filled)


@pytest.fixture(scope="module")
def jax_out():
    """Each case's JAX iteration from its start state, and its draws, in
    one jitted program."""
    starts = {case: _start(case) for case in CASES}

    def program(starts):
        out = {}
        key = jax.random.PRNGKey(KEY)
        for case, (state, env_state, obs) in starts.items():
            jmod = CASES[case][0]
            cfg = _config(jmod, case)
            cfg.action_scale = 2.0
            buffer = jrb.DeviceReplayBuffer(CAP, SPECS)
            if case.startswith("sac"):
                cfg.target_entropy = -1.0
                fn = partial(jsac._sac_iteration, jenv.Pendulum(), buffer,
                             optax.adam(cfg.lr), jsac._static_cfg(cfg))
                tgt = state["target_q"]
            else:
                scfg = (cfg.steps_per_iteration, cfg.train_batch_size,
                        cfg.gamma, cfg.tau, cfg.exploration_noise,
                        cfg.target_noise, cfg.noise_clip, cfg.policy_delay,
                        cfg.action_scale, cfg.learning_starts, cfg.twin_q)
                fn = partial(jtd3._td3_iteration, jenv.Pendulum(), buffer,
                             (optax.adam(cfg.lr), optax.adam(cfg.lr)), scfg)
                tgt = state["target"]
            out[case] = (fn(state["params"], tgt, state["opt_state"],
                            buffer.init(), env_state, obs, jnp.zeros(N),
                            jnp.int32(0), key),
                         _jax_draws(key, case.startswith("sac")))
        return out

    return starts, jax.jit(program)(starts)


def _port(case, state, env_state, obs):
    """The port's algorithm of ``case`` set to the JAX start state through
    the bridge."""
    _, tmod, name, kw = CASES[case]
    algo = getattr(tmod, name)().training(**COMMON, **kw).resources(
        device="cpu").build()
    from_jax = (bridge.sac_state_from_jax if case.startswith("sac")
                else bridge.td3_state_from_jax)
    algo.set_state(from_jax(state, "cpu"))
    for k, v in env_state.items():
        algo.env_state[k].copy_(torch.from_numpy(v))
    algo.obs.copy_(torch.from_numpy(obs))
    return algo


@pytest.mark.parametrize("case", sorted(CASES))
def test_iteration_matches_jax(jax_out, case):
    starts, outs = jax_out
    state, env_state, obs = starts[case]
    (want, draws) = outs[case]
    algo = _port(case, state, env_state, obs)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    sac = case.startswith("sac")
    fn = tsac._sac_iteration if sac else ttd3._td3_iteration
    txs = algo.tx if sac else (algo.tx_actor, algo.tx_critic)
    target = algo.target_q if sac else algo.target
    opt, buf, steps, m = fn(
        algo.env, algo.buffer, txs, algo.config, algo.params, target,
        algo.opt_state, algo.buf_state, algo.env_state, algo.obs,
        algo.ep_ret, 0, draws, None)
    (jparams, jtarget, jopt, jbuf, jenv_state, jobs, jret, jsteps,
     jm) = want
    _close(algo.params, jparams, TOL, "params")
    _close(target, jtarget, TOL, "target")
    if sac:
        pairs = [(opt, jopt[0])]
    else:
        pairs = [(opt[0], jopt[0][0]), (opt[1], jopt[1][0])]
        assert "q2" in algo.params if case == "td3" else \
            "q2" not in algo.params
    for got, st in pairs:
        _close(got["mu"], st.mu, TOL, "mu")
        _close(got["nu"], st.nu, TOL, "nu")
        assert got["count"] == int(st.count)
    counts = [int(st.count) - int(s0.count) for (_, st), s0 in zip(
        pairs, [state["opt_state"][0]] if sac
        else [c[0] for c in state["opt_state"]])]
    assert all(c > 0 for c in counts), counts
    _close(buf.data, jbuf.data, TOL, "buffer")
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
    _close([algo.env_state, algo.obs, algo.ep_ret],
           [jenv_state, jobs, jret], TOL, "env")
    assert steps == int(jsteps) == T * N
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(m[k], float(v), rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert np.isfinite(m["episode_return_mean"])


@pytest.mark.parametrize("name", ["SAC", "TD3", "DDPG"])
def test_state_round_trip_and_refusals(name):
    mod = {"SAC": tsac, "TD3": ttd3, "DDPG": tddpg}[name]
    cfg = getattr(mod, name + "Config")().training(**COMMON)
    algo = cfg.resources(device="cpu").build()
    algo.train()
    state = algo.get_state()
    assert state["total_env_steps"] == T * N
    again = getattr(mod, name + "Config")().training(**COMMON).debugging(
        seed=2).resources(device="cpu").build()
    again.set_state(state)
    obs = np.array([0.3, -0.2, 0.5], np.float32)
    a = algo.compute_single_action(obs)
    np.testing.assert_array_equal(again.compute_single_action(obs), a)
    assert a.shape == (1,) and abs(float(a[0])) <= 2.0
    assert algo.compute_single_action(obs, explore=True).shape == (1,)
    with pytest.raises(ValueError, match="continuous"):
        getattr(mod, name + "Config")().environment("CartPole-v1").resources(
            device="cpu").build()
