"""Port of RLlib's single-device building blocks against the JAX package
on the CPU, at tiny sizes with the same numpy inputs on both sides: the
CartPole and Pendulum dynamics and ``terminal_mask``, GAE and episode
stats, the action distributions and Q heads, ``unroll`` on JAX's own
action and reset draws, one PG, PPO (on JAX's permutations) and A2C
iteration (params after the update), the replay buffers (wraparound; a
prioritized sample on JAX's Gumbel draw), the connectors,
``Learner.update_fn``, checkpoints and the refusals.  Nets are the
port's seeded init carried to JAX through the numpy bridge.  Every JAX
computation of the file runs in ONE jitted program (the ``jax_out``
fixture), so the file pays for one compile."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import connectors as jcon
from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import replay_buffer as jrb
from ray_tpu.rllib import sampler as jsampler
from ray_tpu.rllib.algorithms import a2c as ja2c
from ray_tpu.rllib.algorithms import pg as jpg
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.learner import Learner as JLearner
from ray_tpu.rllib.learner import LearnerSpec as JLearnerSpec
from ray_tpu_torch import bridge
from ray_tpu_torch.rllib import connectors as tcon
from ray_tpu_torch.rllib import env as tenv
from ray_tpu_torch.rllib import models as tmodels
from ray_tpu_torch.rllib import replay_buffer as trb
from ray_tpu_torch.rllib import sampler as tsampler
from ray_tpu_torch.rllib.algorithms import a2c as ta2c
from ray_tpu_torch.rllib.algorithms import pg as tpg
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.learner import (
    Learner,
    LearnerGroup,
    LearnerSpec,
    adam,
    dp_mesh,
    trainable,
)

# f32 on both sides: elementwise maths agrees to an ulp or two; sums and
# matmuls run in other orders.
TOL = 1e-6
UPDATE_TOL = 1e-5
ENVS = {"CartPole": (jenv.CartPole(), tenv.CartPole()),
        "Pendulum": (jenv.Pendulum(), tenv.Pendulum())}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are tiny: one intra-op thread.  A pool of threads a
    worker only contends with the other test workers' (under ``-n 6`` it
    made the port's side of these tests 20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _close(got, want, tol, what="", rtol=0.0):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], tol, f"{what}.{k}", rtol)
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{what}[{i}]", rtol)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=tol,
                                   err_msg=what)


def _reset_draws(name, keys):
    """The [0, 1) floats JAX's ``env.reset(key)`` turns into a state."""
    if name == "CartPole":
        return jax.vmap(lambda k: jax.random.uniform(k, (4,)))(keys)

    def one(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k1, ()),
                          jax.random.uniform(k2, ())])
    return jax.vmap(one)(keys)


def _states(name, n=64, seed=0):
    rng = np.random.default_rng(seed)
    if name == "CartPole":
        state = {"obs": rng.uniform(-0.3, 0.3, (n, 4)).astype(np.float32),
                 "t": rng.integers(495, 500, n).astype(np.int32)}
        state["obs"][:8, 0] = 2.39 + rng.uniform(0, 0.1, 8)
        action = rng.integers(0, 2, n).astype(np.int32)
    else:
        state = {"theta": rng.uniform(-7, 7, n).astype(np.float32),
                 "theta_dot": rng.uniform(-9, 9, n).astype(np.float32),
                 "t": rng.integers(196, 200, n).astype(np.int32)}
        action = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    return state, action


def _gae_case(truncation):
    rng = np.random.default_rng(2)
    T, N = 7, 3
    case = {"reward": rng.normal(size=(T, N)).astype(np.float32),
            "done": rng.random((T, N)) < 0.3,
            "value": rng.normal(size=(T, N)).astype(np.float32),
            "last_value": rng.normal(size=N).astype(np.float32)}
    if truncation:
        case["terminal"] = (case["done"] & (rng.random((T, N)) < 0.5)
                            ).astype(np.float32)
        case["next_value"] = rng.normal(size=(T, N)).astype(np.float32)
    rets = np.where(case["done"], rng.normal(size=(T, N)), np.nan)
    case["episode_return"] = rets.astype(np.float32)
    case["episode_length"] = np.where(case["done"], rng.integers(1, 9, (T, N)),
                                      0).astype(np.int32)
    if truncation:  # no episode finished
        case["episode_return"][:] = np.nan
        case["episode_length"][:] = 0
    return case


def _dist_case():
    rng = np.random.default_rng(4)
    g = torch.Generator().manual_seed(3)
    return {"logits": rng.normal(size=(9, 5)).astype(np.float32),
            "act": rng.integers(0, 5, 9).astype(np.int32),
            "mean": rng.normal(size=(9, 2)).astype(np.float32),
            "log_std": rng.normal(0, 0.3, 2).astype(np.float32),
            "a": rng.normal(size=(9, 2)).astype(np.float32),
            "obs": rng.normal(size=(6, 4)).astype(np.float32),
            "plain": tmodels.init_q_net(g, 4, 3, (16, 8)),
            "dueling": tmodels.init_dueling_q_net(g, 4, 3, (16, 8))}


def _rollout_draws(name, net, key, T, n):
    """JAX's draws inside ``sampler.unroll(..., key, T)``."""
    discrete = ENVS[name][0].discrete
    A = net.act_dim

    def step(step_key):
        k_act, k_reset = jax.random.split(step_key)
        act_keys = jax.random.split(k_act, n)
        draw = jax.random.gumbel if discrete else jax.random.normal
        act = jax.vmap(lambda k: draw(k, (A,)))(act_keys)
        return act, _reset_draws(name, jax.random.split(k_reset, n))

    act, reset = jax.vmap(step)(jax.random.split(key, T))
    return {"action": act, "reset": reset}


def _setup(name, n, hidden=(16, 16), seed=5):
    """The port's net, params and n reset envs (two near their end: one
    at the time limit, one falling), JAX's net."""
    je, te = ENVS[name]
    tnet = tmodels.ActorCritic(te.observation_size, te.action_size,
                               discrete=te.discrete, hidden=hidden)
    jnet = jmodels.ActorCritic(je.observation_size, je.action_size,
                               discrete=je.discrete, hidden=hidden)
    g = torch.Generator().manual_seed(seed)
    params = tnet.init(g)
    state, obs = te.reset(te.draw_reset(g, n))
    state["t"][1] = te.max_steps - 5
    if name == "CartPole":
        state["obs"][0, 2] = 0.2
    return je, te, jnet, tnet, params, state, obs


T_ROLL, N_ENVS = 8, 4
_ALGOS = {  # name: (env, JAX config, JAX iteration, port iteration)
    "PG": ("CartPole", jpg.PGConfig(), jpg._pg_iteration,
           tpg._pg_iteration),
    "PPO": ("CartPole", jppo.PPOConfig().training(
        rollout_length=T_ROLL, num_epochs=2, num_minibatches=2),
        jppo._ppo_iteration, tppo._ppo_iteration),
    "A2C": ("CartPole", ja2c.A2CConfig(), ja2c._a2c_iteration,
            ta2c._a2c_iteration),
}
ON_POLICY = {algo: _setup(name, N_ENVS) for algo, (name, *_) in
             _ALGOS.items()}


def _scfg(algo, cfg):
    if algo == "PPO":
        return jppo._static_cfg(cfg)
    if algo == "PG":
        return (T_ROLL, cfg.vf_loss_coeff, cfg.entropy_coeff, cfg.gamma)
    return (T_ROLL, cfg.vf_loss_coeff, cfg.entropy_coeff, cfg.gamma,
            cfg.lambda_)


def _jtx(cfg):
    return optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                       optax.adam(cfg.lr))


def _ep():
    return (np.arange(N_ENVS, dtype=np.float32),
            np.arange(N_ENVS, dtype=np.int32))


def _on_policy_jax(params):
    """An ``unroll`` of CartPole, one PG, PPO and A2C iteration each, and
    the draws each made (the rollouts', PPO's permutations)."""
    key = jax.random.PRNGKey(11)
    out = {}
    for algo, (name, cfg, jfn, _) in _ALGOS.items():
        je, _, jnet, tnet, _, state, obs = ON_POLICY[algo]
        state, obs, jp = _np(state), _np(obs), params[algo]
        jtx = _jtx(cfg)
        res = jfn(je, jnet, jtx, _scfg(algo, cfg), jp, jtx.init(jp), state,
                  obs, *_ep(), key)
        k_roll = key if algo == "PG" else jax.random.split(key)[0]
        draws = _rollout_draws(name, tnet, k_roll, T_ROLL, N_ENVS)
        if algo == "PPO":
            ek = jax.random.split(jax.random.split(key)[1], 2)
            draws["perms"] = jax.vmap(lambda k: jax.random.permutation(
                k, T_ROLL * N_ENVS))(ek)
            out["unroll"] = jsampler.unroll(je, jnet, jp, state, obs, *_ep(),
                                            k_roll, T_ROLL)
        out[algo] = (res, draws)
    return out


BUF_BATCHES = [{"x": np.full((3, 2), i + 1.0, np.float32),
                "a": np.arange(3 * i, 3 * i + 3, dtype=np.int32)}
               for i in range(3)]  # 3 batches of 3 into capacity 8: wraps
PRIO_FILLS = (9, 2)  # a full wrapped buffer; a spill (tied -inf logits)
UPD_IDX, UPD_TD = np.array([1, 4, 6]), np.array([0.5, -2.0, 0.01],
                                                np.float32)


def _prio_xs(fill_to):
    return [np.arange(i, min(i + 3, fill_to), dtype=np.float32)
            for i in range(0, fill_to, 3)]


def _buffers_jax():
    jbuf = jrb.DeviceReplayBuffer(8, {"x": ((2,), jnp.float32),
                                      "a": ((), jnp.int32)})
    st = jbuf.init()
    for b in BUF_BATCHES:
        st = jbuf.add_batch(st, b)
    out = {"uniform": st}
    jp = jrb.PrioritizedDeviceReplayBuffer(8, {"x": ((), jnp.float32)})
    for fill_to in PRIO_FILLS:
        pst = jp.init()
        for x in _prio_xs(fill_to):
            pst = jp.add_batch(pst, {"x": x})
        if fill_to > 3:
            pst = jp.update_priorities(pst, UPD_IDX, UPD_TD)
        key = jax.random.PRNGKey(fill_to)
        out[f"prio{fill_to}"] = (pst.priority, jax.random.gumbel(key, (8,)),
                        jp.sample(pst, key, 5))
    return out


CONN_XS = [np.random.default_rng(6).normal(2.0, 3.0, (5, 3)).astype(
    np.float32) for _ in range(3)]


def _pipelines(mod):
    return (mod.ConnectorPipeline([mod.MeanStdFilter((3,), clip=1.5),
                                   mod.ClipActions(-1.0, 0.5)]),
            mod.FrameStack(2, (3,)))


def _connectors_jax():
    pipe, fs = _pipelines(jcon)
    st, fst, outs = pipe.init_state(), fs.init_state(), []
    for x in CONN_XS:
        o, st = pipe(x, st)
        fo, fst = fs(x, fst)
        outs.append((o, list(st[0]), fo))
    return outs


LEARN_BATCH = {"x": np.random.default_rng(8).normal(size=(16, 4)).astype(
    np.float32), "y": np.random.default_rng(9).normal(size=(16, 2)).astype(
        np.float32)}
LEARN_PARAMS = tmodels.init_mlp(torch.Generator().manual_seed(1), 4, (8,), 2,
                                final_scale=1.0)
JTX_LEARN = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2))


def _jloss(p, b, rng_):
    err = jmodels.apply_mlp(p, b["x"]) - b["y"]
    return jnp.mean(err ** 2), {"max_err": jnp.max(jnp.abs(err))}


def _learner_jax(jp):
    jl = JLearner(JLearnerSpec(loss_fn=_jloss, optimizer=JTX_LEARN))
    jo, ms = JTX_LEARN.init(jp), []
    for _ in range(2):
        jp, jo, m = jl.update_fn(jp, jo, LEARN_BATCH, jax.random.key(0))
        ms.append(m)
    return jp, jo, ms


@pytest.fixture(scope="module")
def jax_out():
    """Every JAX computation of this file, in one jitted program."""
    envs = {name: (*_states(name), jax.random.split(
        jax.random.PRNGKey(1), 16)) for name in ENVS}
    dist = _dist_case()
    host = {"envs": envs, "gae": [_gae_case(False), _gae_case(True)],
            "dist": {k: (bridge.params_to_numpy(v) if k in ("plain",
                                                            "dueling")
                         else v) for k, v in dist.items()},
            "on_policy": {a: bridge.params_to_numpy(c[4])
                          for a, c in ON_POLICY.items()},
            "learner": bridge.params_to_numpy(LEARN_PARAMS)}

    def program(host):
        out = {"envs": {}}
        for name, (state, action, keys) in host["envs"].items():
            je = ENVS[name][0]
            st = jax.vmap(je.step)(state, action)
            out["envs"][name] = (st, jenv.terminal_mask(je, st[0], st[3]),
                                 jax.vmap(je.reset)(keys),
                                 _reset_draws(name, keys))
        fields = dict.fromkeys(jsampler.Rollout._fields)
        out["gae"] = [
            (jsampler.gae(c["reward"], c["done"], c["value"],
                          c["last_value"], gamma=0.97, lam=0.9,
                          terminal=c.get("terminal"),
                          next_value=c.get("next_value")),
             jsampler.episode_stats(jsampler.Rollout(**{
                 **fields, "episode_return": c["episode_return"],
                 "episode_length": c["episode_length"]})))
            for c in host["gae"]]
        d = host["dist"]
        cat = jmodels.Categorical(d["logits"])
        gau = jmodels.DiagGaussian(d["mean"], d["log_std"])
        out["dist"] = [cat.log_prob(d["act"]), cat.entropy(), cat.mode(),
                       gau.log_prob(d["a"]), gau.entropy(),
                       jmodels.q_values(d["plain"], d["obs"]),
                       jmodels.dueling_q_values(d["dueling"], d["obs"])]
        out["on_policy"] = _on_policy_jax(host["on_policy"])
        out["buffers"] = _buffers_jax()
        out["connectors"] = _connectors_jax()
        out["learner"] = _learner_jax(host["learner"])
        return out

    return host, jax.jit(program)(host)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_reset_step_and_terminal_mask(jax_out, name):
    host, out = jax_out
    te = ENVS[name][1]
    state, action, _ = host["envs"][name]
    want, want_term, (jstate, jobs), draws = out["envs"][name]
    got = te.step({k: _t(v) for k, v in state.items()}, _t(action))
    # Within 1e-6, relative above 1 (Pendulum's costs reach 16, where an
    # f32 ulp is 2e-6).
    _close(got[0], want[0], TOL, "state", rtol=TOL)
    for i in (1, 2, 3):
        _close(got[i], want[i], TOL, str(i), rtol=TOL)
    assert 0 < int(np.sum(np.asarray(want[3]))) < len(action)
    _close(tenv.terminal_mask(te, got[0], got[3]), want_term, 0)
    tstate, tobs = te.reset(_t(draws))
    _close(tstate, jstate, TOL)
    _close(tobs, jobs, TOL)


@pytest.mark.parametrize("truncation", [False, True])
def test_gae_and_episode_stats(jax_out, truncation):
    host, out = jax_out
    c = {k: _t(v) for k, v in host["gae"][truncation].items()}
    want, want_stats = out["gae"][truncation]
    got = tsampler.gae(c["reward"], c["done"], c["value"], c["last_value"],
                       gamma=0.97, lam=0.9, terminal=c.get("terminal"),
                       next_value=c.get("next_value"))
    _close(got, want, TOL)
    roll = tsampler.Rollout(**{**dict.fromkeys(tsampler.Rollout._fields),
                               "episode_return": c["episode_return"],
                               "episode_length": c["episode_length"]})
    _close(tsampler.episode_stats(roll), want_stats, TOL)


def test_distributions_and_q_heads(jax_out):
    host, out = jax_out
    d = {k: (v if k in ("plain", "dueling") else _t(v))
         for k, v in host["dist"].items()}
    qp = _dist_case()
    cat = tmodels.Categorical(d["logits"])
    gau = tmodels.DiagGaussian(d["mean"], d["log_std"])
    got = [cat.log_prob(d["act"]), cat.entropy(), cat.mode(),
           gau.log_prob(d["a"]), gau.entropy(),
           tmodels.q_values(qp["plain"], d["obs"]),
           tmodels.dueling_q_values(qp["dueling"], d["obs"])]
    _close(got, out["dist"], TOL)
    noise = torch.randn((9, 2), generator=torch.Generator().manual_seed(0))
    _close(gau.sample(noise), d["mean"] + torch.exp(d["log_std"]) * noise,
           TOL)
    net = tmodels.ActorCritic(4, 3, discrete=False, hidden=(8,))
    p = net.init(torch.Generator().manual_seed(0))
    assert set(p) == {"pi", "vf", "log_std"}
    assert [tuple(x["w"].shape) for x in p["pi"]["layers"]] == [(4, 8),
                                                                 (8, 3)]


def test_unroll_on_jax_draws_matches_jax(jax_out):
    """CartPole's rollout inside PPO's iteration, on JAX's draws: equal
    trajectories."""
    _, out = jax_out
    _, te, _, tnet, params, state, obs = ON_POLICY["PPO"]
    draws = {k: _t(v) for k, v in out["on_policy"]["PPO"][1].items()}
    got = tsampler.unroll(te, tnet, params, dict(state), obs,
                          *map(_t, _ep()), T_ROLL, draws)
    want = out["on_policy"]["unroll"]
    _close(got[:4], want[:4], UPDATE_TOL)
    for f in tsampler.Rollout._fields:
        g, w = _np(getattr(got[4], f)), np.asarray(getattr(want[4], f))
        np.testing.assert_allclose(g, w, rtol=0, atol=UPDATE_TOL, err_msg=f)
    assert got[4].done.any()


@pytest.mark.parametrize("algo", sorted(_ALGOS))
def test_on_policy_iteration_matches_jax(jax_out, algo):
    """One iteration (rollout, GAE, the loss and its Adam steps, PPO's on
    JAX's permutations) from the same params and env states on JAX's
    draws: metrics, params and moments."""
    _, out = jax_out
    _, te, _, tnet, params, state, obs = ON_POLICY[algo]
    cfg = _ALGOS[algo][1]
    (jparams, jopt, *jenv, jm), draws = out["on_policy"][algo]
    tx = adam(cfg.lr, cfg.grad_clip)
    params = trainable(bridge.params_from_jax(bridge.params_to_numpy(
        params), "cpu"))
    got = _ALGOS[algo][3](te, tnet, tx, _scfg(algo, cfg), params,
                          tx.init(params), dict(state), obs,
                          *map(_t, _ep()),
                          {k: _t(v) for k, v in draws.items()})
    _close(params, jparams, UPDATE_TOL, "params")
    _close(got[1:5], jenv, UPDATE_TOL, "env", rtol=UPDATE_TOL)
    for k, w in jm.items():
        np.testing.assert_allclose(_np(got[5][k]), np.asarray(w),
                                   rtol=UPDATE_TOL, atol=UPDATE_TOL,
                                   err_msg=k)
    _close(got[0]["mu"], jopt[1][0].mu, UPDATE_TOL, "mu")


def test_replay_buffers_wraparound_and_prioritized_sample(jax_out):
    _, out = jax_out
    tbuf = trb.DeviceReplayBuffer(8, {"x": ((2,), torch.float32),
                                      "a": ((), torch.int32)}, "cpu")
    js, ts = out["buffers"]["uniform"], tbuf.init()
    for b in BUF_BATCHES:
        ts = tbuf.add_batch(ts, {k: _t(v) for k, v in b.items()})
    assert (ts.ptr, ts.size) == (int(js.ptr), int(js.size)) == (1, 8)
    _close(ts.data, js.data, 0)
    idx = np.array([0, 7, 3, 3, 5])
    _close(tbuf.sample(ts, _t((idx + 0.5) / 8).float()),
           {k: np.asarray(v)[idx] for k, v in js.data.items()}, 0)
    tp = trb.PrioritizedDeviceReplayBuffer(8, {"x": ((), torch.float32)},
                                           device="cpu")
    for fill_to in PRIO_FILLS:
        jprio, noise, want = out["buffers"][f"prio{fill_to}"]
        tst = tp.init()
        for x in _prio_xs(fill_to):
            tst = tp.add_batch(tst, {"x": _t(x)})
        if fill_to > 3:
            tst = tp.update_priorities(tst, _t(UPD_IDX), _t(UPD_TD))
        _close(tst.priority, jprio, TOL)
        got = tp.sample(tst, _t(noise), 5)
        _close(got[1], want[1], 0, "idx")
        _close(got[2], want[2], TOL, "weights")
        _close(got[0], want[0], 0, "batch")
    for cls in (trb.EpisodeReplayBuffer, trb.HostReplayBuffer):
        jb, tb = getattr(jrb, cls.__name__)(3), cls(3)
        for i in range(5):
            item = {"r": np.arange(i + 2, dtype=np.float32)}
            if cls is trb.HostReplayBuffer:
                jb.add(item), tb.add(item)
            else:
                jb.add_episode(item), tb.add_episode(item)
        if cls is trb.HostReplayBuffer:
            w = jb.sample(4, np.random.default_rng(0))
            g = tb.sample(4, np.random.default_rng(0))
        else:
            w = jb.sample_segments(4, 3, np.random.default_rng(0))
            g = tb.sample_segments(4, 3, np.random.default_rng(0))
        _close(g, w, 0, cls.__name__)


def test_connectors_match_jax(jax_out):
    _, out = jax_out
    pipe, fs = _pipelines(tcon)
    st, fst = pipe.init_state("cpu"), fs.init_state("cpu")
    for x, (jo, jstate, fo) in zip(CONN_XS, out["connectors"]):
        o, st = pipe(_t(x), st)
        _close(o, jo, TOL, rtol=TOL)
        _close(list(st[0]), jstate, TOL, rtol=TOL)
        o, fst = fs(_t(x), fst)
        _close(o, fo, 0)
    img = np.random.default_rng(7).normal(size=(2, 3, 4)).astype(np.float32)
    _close(tcon.FlattenObservations()(_t(img), ())[0], img.reshape(2, 12), 0)


def test_learner_update_matches_jax(jax_out):
    """Two ``update_fn`` steps of an MLP regression loss (clip 0.5 + Adam)
    against the JAX Learner: metrics, params and moments; a mid-run optax
    state across the bridge."""
    _, out = jax_out
    jp, jo, jms = out["learner"]

    def tloss(p, b, rng_):
        err = tmodels.apply_mlp(p, b["x"]) - b["y"]
        return torch.mean(err ** 2), {"max_err": torch.max(err.abs())}

    tl = Learner(LearnerSpec(loss_fn=tloss, optimizer=adam(1e-2, 0.5)))
    params = trainable(bridge.params_from_jax(
        bridge.params_to_numpy(LEARN_PARAMS), "cpu"))
    to = tl.init_optimizer(params)
    tb = {k: _t(v) for k, v in LEARN_BATCH.items()}
    for jm in jms:
        params, to, tm = tl.update_fn(params, to, tb)
        for k in ("loss", "grad_norm", "max_err"):
            np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]),
                                       rtol=0, atol=TOL, err_msg=k)
    _close(params, jp, TOL)
    _close(bridge.opt_state_to_numpy(to)["nu"], jo[1][0].nu, TOL)
    back = bridge.opt_state_from_jax(jax.tree.map(np.asarray, jo), "cpu")
    assert back["count"] == 2
    _close(back["mu"], jo[1][0].mu, 0)
    assert isinstance(back["mu"]["layers"], list)
    again = bridge.opt_state_to_jax(back, jo)
    _close(again[1][0].nu, jo[1][0].nu, 0)


def test_checkpoints_devices_and_refusals(tmp_path):
    algo = (tppo.PPOConfig().training(num_envs=4, rollout_length=16)
            .resources(device="cpu").build())
    algo.train()
    path = algo.save(str(tmp_path / "ckpt.pkl"))
    obs = np.zeros(4, np.float32)
    again = tppo.PPO.from_checkpoint(path)
    assert again.iteration == 1 and again.device.type == "cpu"
    assert algo.compute_single_action(obs) == again.compute_single_action(obs)
    _close(again.params, algo.params, 0)
    pg = (tpg.PGConfig().training(num_envs=2, rollout_length=4)
          .resources(device="cpu").build())
    state = pg.get_state()
    pg.train()
    pg.set_state(state)
    _close(pg.params, state["params"], 0)
    ev = algo.evaluate(num_episodes=1)
    assert ev["evaluation_episode_return_mean"] >= 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tppo.PPOConfig().build()  # the card unless asked otherwise
    with pytest.raises(NotImplementedError, match="multi-device"):
        LearnerGroup(LearnerSpec(lambda p, b, r: (0, {}), adam(1e-3)),
                     num_learners=2)
    with pytest.raises(NotImplementedError, match="multi-device"):
        dp_mesh(2)
    assert dp_mesh(1, ["cpu"]) == (torch.device("cpu"),)
    with pytest.raises(KeyError, match="unknown env"):
        tenv.make_env("nope")
