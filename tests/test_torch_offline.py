"""Port of the offline stack against the JAX package on the CPU: BC, CQL
and MARWIL each run one iteration of a few minibatch updates on a small
seeded dataset with episode ends and time-limit truncations, from one
state (the port's weights, a non-zero Adam state, CQL's targets apart
from its params, MARWIL's ``adv_norm``, carried into the port through the
``bridge`` functions), the port on JAX's own draws: params, targets, Adam
moments and metrics within 1e-5.  MARWIL's return and advantage targets
(GAE and Monte Carlo) and its ``adv_norm`` warm start too.
``OfflineDataset``: ``.npz`` files cross between the packages, and
``collect`` on JAX's reset draws logs JAX's rows.  Also state round trips
and the refusals.  Every jitted JAX computation of the file runs in one
program (the ``jax_out`` fixture)."""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import offline as joff
from ray_tpu_torch import bridge
from ray_tpu_torch.rllib import env as tenv
from ray_tpu_torch.rllib import offline as toff

TOL = 1e-5
ROWS, U, BATCH = 40, 4, 8
HIDDEN = (16,)
KEY = 5


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


def _dataset(cls):
    """ROWS logged Pendulum-like transitions: episodes of 8 rows, every
    other one cut by the time limit, and the log's tail cut mid-episode."""
    rng = np.random.default_rng(0)
    done = np.zeros(ROWS, np.float32)
    done[7::8] = 1.0
    trunc = np.zeros(ROWS, np.float32)
    trunc[15::16] = 1.0
    return cls(obs=rng.normal(size=(ROWS, 3)).astype(np.float32),
               action=rng.uniform(-2, 2, (ROWS, 1)).astype(np.float32),
               reward=rng.uniform(-9, 0, ROWS).astype(np.float32),
               next_obs=rng.normal(size=(ROWS, 3)).astype(np.float32),
               done=done, truncated=trunc)


DATA = _dataset(toff.OfflineDataset)
OPTS = {"BC": {}, "CQL": dict(cql_alpha=0.5), "MARWIL": dict(beta=1.0)}


def _build(name, **kw):
    cfg = getattr(toff, name + "Config")().training(
        updates_per_iteration=U, train_batch_size=BATCH, hidden=HIDDEN,
        **OPTS[name], **kw)
    cfg.dataset = DATA
    return cfg.resources(device="cpu").build()


def _adam_chain(tree, count, rng):
    mu = jax.tree.map(lambda x: rng.normal(0, 0.1, x.shape).astype(
        np.float32), tree)
    nu = jax.tree.map(lambda x: rng.uniform(0.01, 0.2, x.shape).astype(
        np.float32), tree)
    return (optax.ScaleByAdamState(count=np.int32(count), mu=mu, nu=nu),
            optax.EmptyState())


def _start(name):
    """The JAX-format start state of ``name`` from the port's seeded
    weights."""
    algo = _build(name)
    rng = np.random.default_rng(len(name))
    params = bridge.params_to_numpy(algo.params)
    state = {"params": params, "opt_state": _adam_chain(params, 4, rng),
             "iteration": 0, "timesteps_total": 0}
    if name == "CQL":
        state["target_q"] = {k: jax.tree.map(
            lambda x: x + rng.normal(0, 0.01, x.shape).astype(np.float32),
            params[k]) for k in ("q1", "q2")}
    if name == "MARWIL":
        state["adv_norm"] = np.float32(3.5)
    return state


def _columns(name):
    """The columns JAX's learner ``name`` puts on its device."""
    d = DATA
    cols = {"obs": d.obs, "action": d.action}
    if name == "CQL":
        cols.update(reward=d.reward, next_obs=d.next_obs,
                    done=d.done * (1 - d.truncated))
    elif name == "MARWIL":
        cols.update(reward=d.reward, next_obs=d.next_obs, done=d.done,
                    truncated=d.truncated)
    return {k: jnp.asarray(v) for k, v in cols.items()}


def _jax_draws(name, key):
    """The draws of JAX's ``_bc/_cql/_marwil_iteration`` on ``key``."""

    def step(k):
        if name != "CQL":
            return {"idx": jax.random.randint(k, (BATCH,), 0, ROWS)}
        ks, kl = jax.random.split(k)
        k1, k2, k3, k4 = jax.random.split(kl, 4)
        return {"idx": jax.random.randint(ks, (BATCH,), 0, ROWS),
                "next": jax.random.normal(k1, (BATCH, 1)),
                "uniform": jax.random.uniform(k2, (4, BATCH, 1)),
                "policy": jax.random.normal(k3, (4, BATCH, 1)),
                "pi": jax.random.normal(k4, (BATCH, 1))}

    return jax.vmap(step)(jax.random.split(key, U))


def _pendulum_reset(k):
    k1, k2 = jax.random.split(k)
    return jnp.stack([jax.random.uniform(k1, ()),
                      jax.random.uniform(k2, ())])[None]


COLLECT_STEPS, COLLECT_SEED = 12, 3


@pytest.fixture(scope="module")
def jax_out():
    starts = {name: _start(name) for name in OPTS}
    ports = {"MARWIL": _build("MARWIL")}
    mu, sd = ports["MARWIL"]._v_mu, ports["MARWIL"]._v_sd

    def program(starts):
        out, key = {}, jax.random.PRNGKey(KEY)
        cfgs = {name: getattr(joff, name + "Config")().training(
            updates_per_iteration=U, train_batch_size=BATCH, hidden=HIDDEN,
            **OPTS[name]) for name in OPTS}
        for cfg in cfgs.values():
            cfg.action_scale = 2.0
        cfgs["CQL"].target_entropy = -1.0
        for name, st in starts.items():
            cfg, data, tx = cfgs[name], _columns(name), optax.adam(
                cfgs[name].lr)
            if name == "BC":
                res = joff._bc_iteration(tx, joff._bc_static(cfg),
                                         st["params"], st["opt_state"],
                                         data, key)
            elif name == "CQL":
                res = joff._cql_iteration(tx, joff._cql_static(cfg),
                                          st["params"], st["target_q"],
                                          st["opt_state"], data, key)
            else:
                scfg = (U, BATCH, 2.0, cfg.beta, cfg.vf_coeff,
                        cfg.moving_average_sqd_adv_norm_update_rate,
                        cfg.gamma, cfg.lambda_, True, mu, sd)
                res = joff._marwil_iteration(tx, scfg, st["params"],
                                             st["opt_state"], st["adv_norm"],
                                             data, key)
                targets = partial(joff._marwil_targets, st["params"], data,
                                  cfg.gamma, cfg.lambda_)
                out["targets"] = {"gae": targets(True, mu, sd),
                                  "mc": targets(False, mu, sd)}
            out[name] = (res, _jax_draws(name, key))
        # adv_norm's warm start under the port's initial params.
        init = bridge.params_to_numpy(ports["MARWIL"].params)
        _, adv0 = joff._marwil_targets(init, _columns("MARWIL"),
                                       cfgs["MARWIL"].gamma,
                                       cfgs["MARWIL"].lambda_, True, mu, sd)
        out["adv_norm0"] = jnp.mean(adv0 ** 2)
        # Reset draws of the chain of key splits JAX's collect and the
        # JAX tests' rollouts make, one draw a reset.
        out["chains"] = {}
        for seed, n in ((COLLECT_SEED, 22), (11, 3)):
            k, draws = jax.random.key(seed), []
            for _ in range(n):
                k, kr = jax.random.split(k)
                draws.append(_pendulum_reset(kr))
            out["chains"][seed] = jnp.stack(draws)
        return out

    return starts, ports, jax.jit(program)(starts)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_iteration_matches_jax(jax_out, name):
    starts, _, outs = jax_out
    st = starts[name]
    res, draws = outs[name]
    algo = _build(name)
    from_jax = getattr(bridge, name.lower() + "_state_from_jax")
    algo.set_state(from_jax(st, "cpu"))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    draws["idx"] = draws["idx"].long()
    if name == "BC":
        opt, m = toff._bc_iteration(algo.tx, 2.0, algo.params,
                                    algo.opt_state, algo.data, draws)
        jparams, jopt, jm = res
    elif name == "CQL":
        opt, m = toff._cql_iteration(algo.tx, algo.config, algo.params,
                                     algo.target_q, algo.opt_state,
                                     algo.data, draws)
        jparams, jtarget, jopt, jm = res
        _close(algo.target_q, jtarget, TOL, "target_q")
    else:
        assert algo.adv_norm.item() == pytest.approx(3.5)
        opt, c, m = toff._marwil_iteration(
            algo.tx, algo.config, algo._v_mu, algo._v_sd, algo.params,
            algo.opt_state, algo.adv_norm, algo.data, algo.targets(), draws)
        jparams, jopt, jc, jm = res
        np.testing.assert_allclose(float(c), float(jc), rtol=TOL)
    _close(algo.params, jparams, TOL, "params")
    _close(opt["mu"], jopt[0].mu, TOL, "mu")
    _close(opt["nu"], jopt[0].nu, TOL, "nu")
    assert opt["count"] == int(jopt[0].count) == 4 + U
    assert set(m) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(m[k], float(v), rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("use_gae", [True, False], ids=["gae", "mc"])
def test_marwil_targets_and_warm_start(jax_out, use_gae):
    starts, ports, outs = jax_out
    algo = ports["MARWIL"]
    np.testing.assert_allclose(float(algo.adv_norm), float(outs["adv_norm0"]),
                               rtol=TOL)
    algo = _build("MARWIL", use_gae=use_gae)
    algo.set_state(bridge.marwil_state_from_jax(starts["MARWIL"], "cpu"))
    rtg, adv = algo.targets()
    want = outs["targets"]["gae" if use_gae else "mc"]
    _close([rtg, adv], want, TOL, "targets")


def test_dataset_files_cross_between_packages(tmp_path):
    jds = _dataset(joff.OfflineDataset)
    jds.save(str(tmp_path / "jax.npz"))
    got = toff.OfflineDataset.load(str(tmp_path / "jax.npz"))
    DATA.save(str(tmp_path / "port.npz"))
    back = joff.OfflineDataset.load(str(tmp_path / "port.npz"))
    for c in ("obs", "action", "reward", "next_obs", "done", "truncated"):
        np.testing.assert_array_equal(getattr(got, c), getattr(jds, c))
        np.testing.assert_array_equal(getattr(back, c), getattr(DATA, c))
    # A file without the optional column loads with zeros there.
    np.savez(tmp_path / "old.npz", obs=DATA.obs, action=DATA.action,
             reward=DATA.reward, next_obs=DATA.next_obs, done=DATA.done)
    old = toff.OfflineDataset.load(str(tmp_path / "old.npz"))
    assert len(old) == ROWS and not old.truncated.any()


@pytest.mark.parametrize("name,rows", [("pendulum_sac18_4000", 4000),
                                       ("pendulum_sac15_3000", 3000)])
def test_jax_fixture_datasets_load_in_both_packages(name, rows):
    """The JAX tests' datasets the smoke's offline gates run on
    (scripts/make_offline_fixtures.py): 200-step episodes cut by the time
    limit, read alike by both packages."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "data", name + ".npz")
    got, want = toff.OfflineDataset.load(path), joff.OfflineDataset.load(path)
    assert len(got) == rows and got.obs.shape == (rows, 3)
    assert got.action.shape == (rows, 1) and np.abs(got.action).max() <= 2
    assert got.done.sum() == rows // 200 == got.truncated.sum()
    for c in ("obs", "action", "reward", "next_obs", "done", "truncated"):
        np.testing.assert_array_equal(getattr(got, c), getattr(want, c))


def _policy(obs, rng):
    return np.clip(1.5 * obs[:1] + rng.normal(0, 0.3, 1), -2.0, 2.0
                   ).astype(np.float32)


def test_collect_matches_jax(jax_out):
    outs = jax_out[2]
    want = joff.OfflineDataset.collect(jenv.Pendulum(max_steps=5), _policy,
                                       num_steps=COLLECT_STEPS,
                                       seed=COLLECT_SEED)
    got = toff.OfflineDataset.collect(
        tenv.Pendulum(max_steps=5), _policy, num_steps=COLLECT_STEPS,
        seed=COLLECT_SEED,
        reset_draws=np.asarray(outs["chains"][COLLECT_SEED]))
    assert got.done.sum() == 2 and got.truncated.sum() == 2
    for c in ("obs", "action", "reward", "next_obs", "done", "truncated"):
        np.testing.assert_allclose(getattr(got, c), getattr(want, c),
                                   rtol=TOL, atol=TOL, err_msg=c)
    # By default the resets come from the seed.
    again = toff.OfflineDataset.collect(
        tenv.Pendulum(max_steps=5), _policy, num_steps=COLLECT_STEPS,
        seed=COLLECT_SEED)
    np.testing.assert_array_equal(
        again.obs, toff.OfflineDataset.collect(
            tenv.Pendulum(max_steps=5), _policy, num_steps=COLLECT_STEPS,
            seed=COLLECT_SEED).obs)


def test_smoke_start_states_are_jax_draws(jax_out):
    """chip_smoke.py's phase 20 starts its datasets and rollouts where
    the JAX tests' do: its constants are JAX's reset-chain draws."""
    import chip_smoke
    for seed, chain in jax_out[2]["chains"].items():
        np.testing.assert_array_equal(
            np.array(chip_smoke.RL20_JAX_RESETS[seed], np.float32),
            np.asarray(chain)[:, 0])


@pytest.mark.parametrize("name", sorted(OPTS))
def test_state_round_trip_and_refusals(name):
    algo = _build(name)
    m = algo.train()
    assert all(np.isfinite(v) for k, v in m.items()
               if k != "episode_return_mean")
    again = _build(name, seed=4)
    again.set_state(algo.get_state())
    obs = np.array([0.3, -0.2, 0.5], np.float32)
    a = algo.compute_single_action(obs)
    np.testing.assert_array_equal(again.compute_single_action(obs), a)
    assert a.shape == (1,) and abs(float(a[0])) <= 2.0
    cfg = getattr(toff, name + "Config")()
    with pytest.raises(ValueError, match="dataset"):
        cfg.resources(device="cpu").build()
    cfg.dataset = DATA
    with pytest.raises(ValueError, match="continuous"):
        cfg.environment("CartPole-v1").build()
