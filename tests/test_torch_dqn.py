"""Port of DQN against the JAX package on the CPU: a few env steps of the
iteration (epsilon-greedy acting, buffer writes that wrap, double-Q TD
updates with a dueling head on the uniform buffer, then C51 updates on
the prioritized buffer, target syncs) from the same weights and env
states, the port on JAX's own draws — params, target params, Adam
moments, the buffer and the metrics within 1e-5.  Also a state round
trip and the refusals.  Both JAX iterations, and the draws they make,
run in one jitted program (the ``jax_out`` fixture)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import replay_buffer as jrb
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu_torch import bridge
from ray_tpu_torch.rllib.algorithms import dqn as tdqn

TOL = 1e-5
T, N, BATCH, CAP = 6, 4, 8, 16
CASES = {
    "double_q_dueling": dict(dueling=True, double_q=True),
    "c51_prioritized": dict(num_atoms=11, v_min=0.0, v_max=10.0,
                            prioritized_replay=True, double_q=False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are tiny: one intra-op thread.  A pool of threads a
    worker only contends with the other test workers' (under ``-n 6`` it
    made the port's side of these tests 20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(mod, kw):
    return mod.DQNConfig().training(
        num_envs=N, steps_per_iteration=T, learning_starts=8,
        train_batch_size=BATCH, buffer_capacity=CAP, target_update_freq=8,
        epsilon_decay_steps=40, hidden=(16,), lr=1e-2, **kw)


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
        for k in want:
            _close(got[k], want[k], tol, f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{what}[{i}]")
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=what)


def _jax_draws(key, prioritized):
    """The draws of JAX's ``_dqn_iteration`` on ``key``: epsilon tests,
    random actions, resets and the buffer sample's (the uniform buffer's
    slot indices at each step's fill count, as [0, 1) draws; the
    prioritized buffer's Gumbel noise)."""

    def step(sk, filled):
        k_eps, k_act, k_reset, k_sample = jax.random.split(sk, 4)
        out = {"eps": jax.random.uniform(k_eps, (N,)),
               "random_action": jax.random.randint(k_act, (N,), 0, 2),
               "reset": jax.vmap(lambda k: jax.random.uniform(k, (4,)))(
                   jax.random.split(k_reset, N))}
        if prioritized:
            out["noise"] = jax.random.gumbel(k_sample, (CAP,))
        else:
            idx = jax.random.randint(k_sample, (BATCH,), 0, filled)
            out["sample"] = (idx + 0.5) / filled
        return out

    filled = np.minimum(np.arange(1, T + 1) * N, CAP)
    return jax.vmap(step)(jax.random.split(key, T), filled)


def _jax_iteration(cfg):
    """JAX's ``_dqn_iteration`` with its heads and buffer as ``DQN._setup``
    makes them (dqn.py:78-140; the C51 head's two closures written out
    here), jitted."""
    if cfg.num_atoms > 1:
        K, z = cfg.num_atoms, jnp.linspace(cfg.v_min, cfg.v_max,
                                           cfg.num_atoms)

        def dist_fn(p, obs):
            out = jmodels.q_values(p, obs)
            return out.reshape(out.shape[:-1] + (2, K))

        def q_fn(p, obs):
            return jnp.sum(jax.nn.softmax(dist_fn(p, obs), axis=-1) * z,
                           axis=-1)
    else:
        dist_fn = None
        q_fn = jmodels.dueling_q_values if cfg.dueling else jmodels.q_values
    specs = {"obs": ((4,), jnp.float32), "action": ((), jnp.int32),
             "reward": ((), jnp.float32), "next_obs": ((4,), jnp.float32),
             "done": ((), jnp.float32)}
    buffer = (jrb.PrioritizedDeviceReplayBuffer(
        CAP, specs, alpha=cfg.prioritized_replay_alpha,
        beta=cfg.prioritized_replay_beta) if cfg.prioritized_replay
        else jrb.DeviceReplayBuffer(CAP, specs))
    tx = optax.adam(cfg.lr)
    fn = partial(jdqn._dqn_iteration, jenv.CartPole(), buffer, tx, q_fn,
                 dist_fn, jdqn._static_cfg(cfg))
    return fn, tx, buffer


def _port_algo(case):
    """The port's DQN for ``case``: two envs near the time limit and one
    near falling, so episodes finish inside the run."""
    algo = tdqn.DQN(config=_config(tdqn, CASES[case]).resources(
        device="cpu"))
    algo.env_state["t"][:2] = 498
    algo.env_state["obs"][2, 2] = 0.2
    algo.obs = algo.env_state["obs"]
    return algo


KEY = 3


@pytest.fixture(scope="module")
def jax_out():
    """Each case's JAX iteration from the port's starting point, and its
    draws, in one jitted program."""
    starts = {}
    for case in CASES:
        algo = _port_algo(case)
        starts[case] = (bridge.params_to_numpy(algo.params),
                        _np(algo.env_state), _np(algo.obs))

    def program(starts):
        out = {}
        key = jax.random.PRNGKey(KEY)
        for case, (jp, env_state, obs) in starts.items():
            fn, tx, buffer = _jax_iteration(_config(jdqn, CASES[case]))
            out[case] = (fn(jp, jp, tx.init(jp), buffer.init(), env_state,
                            obs, jnp.zeros(N), jnp.int32(0), key),
                         _jax_draws(key, "prioritized_replay" in
                                    CASES[case]))
        return out

    return jax.jit(program)(starts)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dqn_iteration_matches_jax(jax_out, case):
    kw = CASES[case]
    talgo = _port_algo(case)
    want, draws = jax_out[case]
    got = tdqn._dqn_iteration(
        talgo.env, talgo.buffer, talgo.tx, talgo._q_fn, talgo._dist_fn,
        talgo.config, talgo.params, talgo.target_params, talgo.opt_state,
        talgo.buf_state, talgo.env_state, talgo.obs, talgo.ep_ret, 0,
        {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}, None)
    (jparams, jtarget, jopt, jbuf, jenv, jobs, jret, jsteps, jm) = want
    (buf, env_state, obs, ep_ret, steps, opt, m) = got
    _close(talgo.params, jparams, TOL, "params")
    _close(talgo.target_params, jtarget, TOL, "target")
    _close(opt["mu"], jopt[0].mu, TOL, "mu")
    _close(opt["nu"], jopt[0].nu, TOL, "nu")
    assert opt["count"] == int(jopt[0].count) > 0
    base = buf.base if "prioritized_replay" in kw else buf
    jbase = jbuf.base if "prioritized_replay" in kw else jbuf
    _close(base.data, jbase.data, TOL, "buffer")
    assert (base.ptr, base.size) == (int(jbase.ptr), int(jbase.size))
    if "prioritized_replay" in kw:
        _close(buf.priority, jbuf.priority, TOL, "priority")
    _close([env_state, obs, ep_ret], [jenv, jobs, jret], TOL, "env")
    assert steps == int(jsteps) == T * N
    for k, v in jm.items():
        np.testing.assert_allclose(m[k], float(v), rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert np.isfinite(m["episode_return_mean"])


def test_state_round_trip_and_refusals():
    algo = tdqn.DQN(config=_config(tdqn, {}).resources(device="cpu"))
    algo.train()
    state = algo.get_state()
    assert state["total_env_steps"] == T * N
    again = tdqn.DQN(config=_config(tdqn, {}).resources(device="cpu"))
    again.set_state(state)
    obs = np.array([0.01, -0.02, 0.03, 0.0], np.float32)
    assert again.compute_single_action(obs) == algo.compute_single_action(obs)
    assert again.total_env_steps == T * N
    with pytest.raises(ValueError, match="dueling"):
        tdqn.DQN(config=_config(tdqn, dict(num_atoms=11, dueling=True))
                 .resources(device="cpu"))
    with pytest.raises(ValueError, match="discrete"):
        tdqn.DQN(config=_config(tdqn, {}).environment("Pendulum-v1")
                 .resources(device="cpu"))
