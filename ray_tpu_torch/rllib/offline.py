"""Offline RL: datasets of logged transitions and the BC, CQL and MARWIL
learners (port of ``ray_tpu/rllib/offline.py``).

An :class:`OfflineDataset` is host numpy, saved and loaded as ``.npz``
under the JAX package's field names, so a file written by either package
loads in the other.  Each learner moves the columns it reads to its own
device and runs ``updates_per_iteration`` minibatch updates an
iteration, on batch indices (and, for CQL, the loss's normal and uniform
draws) drawn first, in one go, on its seeded CPU generator.  On the card
CQL's update runs as one CUDA graph; BC's and MARWIL's run eagerly.
MARWIL's return and advantage targets are two reverse recurrences over
the whole dataset: the values come from the device, the recurrences run
on the host in float32, in the JAX scan's order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    to_device,
    to_host,
)
from ray_tpu_torch.rllib.algorithms._off_policy import (
    bias_table,
    detach,
    polyak_,
    run_graph,
)
from ray_tpu_torch.rllib.algorithms.sac import (
    _actor_dist,
    _q,
    _sample_squashed,
    init_sac_params,
)
from ray_tpu_torch.rllib.env import _uniform, terminal_mask
from ray_tpu_torch.rllib.learner import (
    adam,
    apply_gradients,
    trainable,
    value_and_grad,
)
from ray_tpu_torch.rllib.models import apply_mlp, init_mlp

_COLUMNS = ("obs", "action", "reward", "next_obs", "done", "truncated")


@dataclasses.dataclass
class OfflineDataset:
    """Logged transitions as stacked arrays (the SampleBatch columns
    offline readers produce)."""

    obs: np.ndarray        # [N, obs_dim]
    action: np.ndarray     # [N, act_dim] (continuous) or [N] (discrete)
    reward: np.ndarray     # [N]
    next_obs: np.ndarray   # [N, obs_dim]
    done: np.ndarray       # [N] episode boundary (terminal OR time limit)
    # 1.0 where the episode ended by TIME LIMIT, not a true terminal:
    # return targets bootstrap V(next_obs) there.
    truncated: np.ndarray = None

    def __post_init__(self):
        if self.truncated is None:
            self.truncated = np.zeros_like(np.asarray(self.done))

    def __len__(self) -> int:
        return len(self.obs)

    @classmethod
    def collect(cls, env, policy: Callable[[np.ndarray, np.random.Generator],
                                           np.ndarray],
                *, num_steps: int, seed: int = 0,
                reset_draws=None) -> "OfflineDataset":
        """Roll a host-side policy through one of the port's envs, on the
        CPU, to build a logged dataset.  ``policy(obs, rng)`` gets a numpy
        generator seeded with ``seed``; the env's resets take
        ``reset_draws`` ([resets, 1, ...] uniform draws, one set a reset,
        at most ``num_steps + 1`` used), by default drawn in one go from a
        CPU generator seeded with ``seed``."""
        rng = np.random.default_rng(seed)
        if reset_draws is None:
            reset_draws = env.draw_reset(torch.Generator().manual_seed(seed),
                                         1, (num_steps + 1,))
        resets = iter(torch.as_tensor(np.array(reset_draws, np.float32)))
        state, obs = env.reset(next(resets))
        rows: Dict[str, list] = {c: [] for c in _COLUMNS}
        for _ in range(num_steps):
            o = obs[0].numpy()
            a = np.asarray(policy(o, rng), np.float32)
            state, nobs, r, d = env.step(state, torch.from_numpy(a)[None])
            done = bool(d[0])
            rows["obs"].append(o)
            rows["action"].append(a)
            rows["reward"].append(float(r[0]))
            rows["next_obs"].append(nobs[0].numpy())
            rows["done"].append(float(done))
            # Time-limit detection: done minus the true terminal.
            term = float(terminal_mask(env, state, d)[0])
            rows["truncated"].append(float(done) - term)
            if done:
                state, obs = env.reset(next(resets))
            else:
                obs = nobs
        return cls(**{c: np.asarray(v, np.float32) for c, v in rows.items()})

    def save(self, path: str) -> None:
        np.savez(path, obs=self.obs, action=self.action,
                 reward=self.reward, next_obs=self.next_obs,
                 done=self.done, truncated=self.truncated)

    @classmethod
    def load(cls, path: str) -> "OfflineDataset":
        z = np.load(path)
        return cls(obs=z["obs"], action=z["action"], reward=z["reward"],
                   next_obs=z["next_obs"], done=z["done"],
                   truncated=z["truncated"] if "truncated" in z else None)


class _OfflineAlgorithm(Algorithm):
    """What BC, CQL and MARWIL share: the refusals, the action scale, the
    deterministic action, the batch-index draws and the state."""

    _state_trees = ("params", "opt_state")

    def _check(self, name: str) -> None:
        cfg = self.config
        if cfg.dataset is None:
            raise ValueError(f"{name}Config.dataset is required (offline)")
        if self.env.discrete:
            raise ValueError(f"this {name} targets continuous actions")
        if cfg.action_scale is None:
            cfg.action_scale = float(getattr(self.env, "max_torque", 1.0))

    def _columns(self, **cols) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
                for k, v in cols.items()}

    def _actor(self):
        return self.params["actor"]

    def _index_draws(self) -> torch.Tensor:
        cfg = self.config
        return torch.randint(0, len(cfg.dataset), (cfg.updates_per_iteration,
                                                   cfg.train_batch_size),
                             generator=self._gen)

    def _draws(self) -> Dict[str, torch.Tensor]:
        return {"idx": self._index_draws().to(self.device)}

    def _finish(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(metrics)
        out["_timesteps"] = (self.config.updates_per_iteration
                             * self.config.train_batch_size)
        return out

    def compute_single_action(self, obs, explore: bool = False):
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)[None]
        with torch.no_grad():
            mu, _ = _actor_dist(self._actor(), obs)
            return (torch.tanh(mu[0]) * self.config.action_scale
                    ).cpu().numpy()

    def get_state(self) -> Dict[str, Any]:
        state = {k: to_host(getattr(self, k)) for k in self._state_trees}
        state.update(iteration=self.iteration,
                     timesteps_total=self._timesteps_total)
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        for k in self._state_trees:
            setattr(self, k, to_device(state[k], self.device,
                                       grad=k == "params"))
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]


def _means(rows) -> Dict[str, float]:
    """Per-update aux dicts → the mean of each, as host floats (one
    copy)."""
    keys = list(rows[0])
    vals = torch.stack([torch.stack([r[k] for r in rows]).mean()
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


# --- BC ---------------------------------------------------------------------

class BCConfig(AlgorithmConfig):
    """Behavior cloning."""

    def __init__(self):
        super().__init__()
        self.env = "Pendulum-v1"
        self.dataset: Optional[OfflineDataset] = None
        self.train_batch_size = 256
        self.updates_per_iteration = 64
        self.action_scale: float = None
        self.lr = 1e-3
        self.hidden = (128, 128)

    @property
    def algo_class(self):
        return BC


class BC(_OfflineAlgorithm):
    """Regression onto the logged actions: the MSE between the squashed
    policy mean and the logged action (what the JAX package's code does;
    its docstring says NLL)."""

    config_class = BCConfig

    def _setup(self) -> None:
        cfg, env = self.config, self.env
        self._check("BC")
        self.params = trainable(init_mlp(
            self._gen, env.observation_size, cfg.hidden,
            2 * env.action_size, final_scale=0.01, device=self.device))
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        self.data = self._columns(obs=cfg.dataset.obs,
                                  action=cfg.dataset.action)

    def _actor(self):
        return self.params

    def _train_once(self) -> Dict[str, Any]:
        self.opt_state, metrics = _bc_iteration(
            self.tx, self.config.action_scale, self.params, self.opt_state,
            self.data, self._draws())
        return self._finish(metrics)


def bc_loss(scale, p, obs, act):
    # Deterministic cloning in ACTION space: a Gaussian NLL on the
    # pre-squash value blows up on saturated logged actions.
    mu, _ = _actor_dist(p, obs)
    return torch.mean((torch.tanh(mu) * scale - act) ** 2), {}


def _bc_iteration(tx, scale, params, opt_state, data, draws):
    """One update per row of ``draws["idx"]`` [U, B]; params updated in
    place.  Returns (opt_state, metrics)."""
    losses = []
    for idx in draws["idx"]:
        obs, act = data["obs"][idx], data["action"][idx]
        opt_state, loss, _, _ = apply_gradients(
            tx, params, opt_state, lambda p: bc_loss(scale, p, obs, act))
        losses.append({"bc_loss": loss})
    return opt_state, _means(losses)


# --- CQL --------------------------------------------------------------------

class CQLConfig(AlgorithmConfig):
    """Conservative Q-learning: SAC's losses plus the conservative penalty
    that pushes Q down on out-of-distribution actions."""

    def __init__(self):
        super().__init__()
        self.env = "Pendulum-v1"
        self.dataset: Optional[OfflineDataset] = None
        self.train_batch_size = 256
        self.updates_per_iteration = 64
        self.cql_alpha = 1.0          # conservative penalty weight
        self.cql_num_actions = 4      # sampled actions for the logsumexp
        # TD3+BC-style regularizer: the actor objective is normalized
        # by mean |Q| and anchored to the dataset actions.
        self.actor_bc_weight = 1.0
        self.tau = 0.005
        self.init_alpha = 0.1
        self.target_entropy: float = None
        self.action_scale: float = None
        self.lr = 3e-4
        self.hidden = (128, 128)

    @property
    def algo_class(self):
        return CQL


class CQL(_OfflineAlgorithm):
    config_class = CQLConfig
    _state_trees = ("params", "target_q", "opt_state")

    def _setup(self) -> None:
        cfg, env, dev = self.config, self.env, self.device
        self._check("CQL")
        obs_dim, act_dim = env.observation_size, env.action_size
        if cfg.target_entropy is None:
            cfg.target_entropy = -float(act_dim)
        self.params = init_sac_params(self._gen, obs_dim, act_dim,
                                      cfg.hidden, cfg.init_alpha, dev)
        self.target_q = to_device({"q1": self.params["q1"],
                                   "q2": self.params["q2"]}, dev)
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        d = cfg.dataset
        # The TD target bootstraps through time-limit truncations: only
        # TRUE terminals zero the next-state value.
        terminal = (np.asarray(d.done, np.float32)
                    * (1.0 - np.asarray(d.truncated, np.float32)))
        self.data = self._columns(obs=d.obs, action=d.action,
                                  reward=d.reward, next_obs=d.next_obs,
                                  done=terminal)
        self._graphs = {} if dev.type == "cuda" else None

    def _draws(self) -> Dict[str, torch.Tensor]:
        cfg, g = self.config, self._gen
        U, B, K = (cfg.updates_per_iteration, cfg.train_batch_size,
                   cfg.cql_num_actions)
        A = self.env.action_size
        draws = {"idx": self._index_draws(),
                 "next": torch.randn((U, B, A), generator=g),
                 "uniform": torch.rand((U, K, B, A), generator=g),
                 "policy": torch.randn((U, K, B, A), generator=g),
                 "pi": torch.randn((U, B, A), generator=g)}
        return {k: v.to(self.device) for k, v in draws.items()}

    def _train_once(self) -> Dict[str, Any]:
        self.opt_state, metrics = _cql_iteration(
            self.tx, self.config, self.params, self.target_q, self.opt_state,
            self.data, self._draws(), self._graphs)
        return self._finish(metrics)

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        if self._graphs is not None:
            self._graphs = {}  # they hold the replaced tensors


def cql_losses(cfg, p, tq, mb, dr):
    """SAC's critic, actor and temperature losses plus the conservative
    penalty (CQL(H): logsumexp over uniform and policy actions minus
    log(2·n_cql), minus the data actions' Q), the actor anchored to the
    logged actions (TD3+BC); ``dr``: one update's draws."""
    gamma, scale = cfg.gamma, cfg.action_scale
    n_cql = cfg.cql_num_actions
    alpha = torch.exp(p["log_alpha"])
    with torch.no_grad():
        a_next, logp_next = _sample_squashed(p["actor"], mb["next_obs"],
                                             dr["next"], scale)
        q_next = torch.minimum(_q(tq["q1"], mb["next_obs"], a_next),
                               _q(tq["q2"], mb["next_obs"], a_next)
                               ) - alpha * logp_next
        target = mb["reward"] + gamma * (1 - mb["done"]) * q_next
    q1 = _q(p["q1"], mb["obs"], mb["action"])
    q2 = _q(p["q2"], mb["obs"], mb["action"])
    bellman = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)
    rand_a = _uniform(dr["uniform"], -scale, scale)         # [K, B, A]
    obs_k = mb["obs"].expand((n_cql,) + mb["obs"].shape)
    # The conservative penalty trains CRITICS only: the policy sample is
    # detached.
    with torch.no_grad():
        pol_a, _ = _sample_squashed(p["actor"], obs_k, dr["policy"], scale)

    log_2n = float(np.log(np.float32(2.0 * n_cql)))  # jnp.log, in f32

    def q_all(qp):
        cat = torch.cat([_q(qp, obs_k, rand_a), _q(qp, obs_k, pol_a)], 0)
        return torch.logsumexp(cat, dim=0) - log_2n

    cql_pen = (torch.mean(q_all(p["q1"]) - q1)
               + torch.mean(q_all(p["q2"]) - q2))
    # SAC actor + temperature on dataset states, normalized by mean |Q|
    # and anchored to logged actions.
    a_pi, logp_pi = _sample_squashed(p["actor"], mb["obs"], dr["pi"], scale)
    q_pi = torch.minimum(_q(detach(p["q1"]), mb["obs"], a_pi),
                         _q(detach(p["q2"]), mb["obs"], a_pi))
    q_norm = (torch.mean(torch.abs(q_pi)) + 1e-6).detach()
    mu, _ = _actor_dist(p["actor"], mb["obs"])
    bc_mse = torch.mean((torch.tanh(mu) * scale - mb["action"]) ** 2)
    actor_loss = (torch.mean(alpha.detach() * logp_pi - q_pi) / q_norm
                  + cfg.actor_bc_weight * bc_mse)
    alpha_loss = -torch.mean(p["log_alpha"]
                             * (logp_pi + cfg.target_entropy).detach())
    total = bellman + cfg.cql_alpha * cql_pen + actor_loss + alpha_loss
    return total, {"bellman": bellman, "cql_penalty": cql_pen,
                   "actor_loss": actor_loss, "alpha": alpha}


_CQL_AUX = ("actor_loss", "alpha", "bellman", "cql_penalty")


class _CQLSteps:
    """CQL's update over tensors changed in place: a minibatch by the
    update counter's row of the draws, the loss, the Adam update (bias
    corrections by the counter), the Polyak step, the aux sums."""

    def __init__(self, tx, cfg, params, target_q, data, draws):
        dev = data["obs"].device
        self.tx, self.cfg, self.data = tx, cfg, data
        self.params, self.target_q = params, target_q
        self.opt_state = None
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.draws = {k: v.clone() for k, v in draws.items()}
        self.bias = torch.zeros((cfg.updates_per_iteration, 2), device=dev)
        self.sums = torch.zeros((len(_CQL_AUX),), device=dev)

    def begin(self, draws, opt_state) -> None:
        for k, v in draws.items():
            self.draws[k].copy_(v)
        self.opt_state = opt_state
        self.bias.copy_(bias_table(self.tx, opt_state["count"],
                                   self.cfg.updates_per_iteration,
                                   self.bias.device))
        self.k.zero_()
        self.sums.zero_()

    def learn(self) -> None:
        dr = {k: v.index_select(0, self.k)[0] for k, v in self.draws.items()}
        mb = {c: v.index_select(0, dr["idx"]) for c, v in self.data.items()}
        (_, aux), grads = value_and_grad(
            lambda p: cql_losses(self.cfg, p, self.target_q, mb, dr),
            trainable(self.params))
        bias = self.bias.index_select(0, self.k)[0]
        self.tx.update_(self.params, grads, self.opt_state,
                        bias=(bias[0], bias[1]))
        polyak_(self.target_q, {"q1": self.params["q1"],
                                "q2": self.params["q2"]}, self.cfg.tau)
        self.sums.add_(torch.stack([aux[k].detach() for k in _CQL_AUX]))
        self.k.add_(1)


def _cql_iteration(tx, cfg, params, target_q, opt_state, data, draws,
                   graphs=None):
    """``cfg.updates_per_iteration`` updates on ``draws`` (see
    ``CQL._draws``); params, targets and moments updated in place.  With
    ``graphs`` (a dict kept across iterations, on the card) the update
    runs as a CUDA graph.  Returns (opt_state, metrics)."""
    U = cfg.updates_per_iteration
    steps = graphs.get("steps") if graphs is not None else None
    if steps is None:
        steps = _CQLSteps(tx, cfg, params, target_q, data, draws)
        if graphs is not None:
            graphs["steps"] = steps
    steps.begin(draws, opt_state)
    for _ in range(U):
        run_graph(graphs, "learn", steps.learn)
    opt_state = dict(opt_state, count=opt_state["count"] + U)
    return opt_state, dict(zip(_CQL_AUX, (steps.sums / U).tolist()))


# --- MARWIL -----------------------------------------------------------------

class MARWILConfig(AlgorithmConfig):
    """MARWIL — monotonic advantage re-weighted imitation learning: a
    value network fit on the logged data plus exponentially
    advantage-weighted behavior cloning; beta=0 is plain BC."""

    def __init__(self):
        super().__init__()
        self.env = "Pendulum-v1"
        self.dataset: Optional[OfflineDataset] = None
        self.train_batch_size = 256
        self.updates_per_iteration = 64
        self.action_scale: float = None
        self.lr = 1e-3
        self.beta = 1.0           # advantage weighting temperature
        self.vf_coeff = 1.0
        self.moving_average_sqd_adv_norm_update_rate = 1e-2
        # GAE(lambda) advantages; False: the Monte-Carlo R - V(s).
        self.use_gae = True
        self.lambda_ = 0.95
        self.hidden = (128, 128)

    @property
    def algo_class(self):
        return MARWIL


class MARWIL(_OfflineAlgorithm):
    """Advantage-weighted cloning: fit V on the logged episodes' returns
    to go, weight each cloning term by exp(beta * A / sqrt(c)) (clipped to
    ±5 in the exponent, normalised to batch mean 1), c a moving E[A²].
    Episodes cut by the time limit bootstrap V(next_obs) at the cut, and
    c starts at the data's E[A²] under the initial V, as in the JAX
    package."""

    config_class = MARWILConfig

    def _setup(self) -> None:
        cfg, env, dev = self.config, self.env, self.device
        self._check("MARWIL")
        obs_dim, act_dim = env.observation_size, env.action_size
        self.params = trainable({
            "actor": init_mlp(self._gen, obs_dim, cfg.hidden, 2 * act_dim,
                              final_scale=0.01, device=dev),
            "value": init_mlp(self._gen, obs_dim, cfg.hidden, 1,
                              final_scale=1.0, device=dev),
        })
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        ds = cfg.dataset
        self.data = self._columns(obs=ds.obs, action=ds.action,
                                  next_obs=ds.next_obs)
        self._host = {"reward": np.asarray(ds.reward, np.float32),
                      "done": np.asarray(ds.done, np.float32),
                      "truncated": np.asarray(ds.truncated, np.float32)}
        # The value head regresses (ret - mu) / sd: mu and sd from the
        # dataset's reward-only returns to go, as the JAX package computes
        # them (numpy, population std).
        r, d = self._host["reward"], self._host["done"]
        rtg = np.zeros_like(r)
        acc = 0.0
        for t in range(len(r) - 1, -1, -1):
            acc = r[t] + cfg.gamma * acc * (1.0 - d[t])
            rtg[t] = acc
        self._v_mu = float(rtg.mean())
        self._v_sd = float(rtg.std() + 1e-6)
        # Warm-start the running E[A^2] at the data scale under the
        # initial V so the first updates' weights are near-uniform.
        _, adv0 = self.targets()
        self.adv_norm = torch.mean(adv0 ** 2)

    def targets(self):
        """(rtg, adv) under the current value params (see
        :func:`marwil_targets`)."""
        cfg = self.config
        return marwil_targets(self.params, self.data, self._host, cfg.gamma,
                              cfg.lambda_, cfg.use_gae, self._v_mu,
                              self._v_sd)

    def _train_once(self) -> Dict[str, Any]:
        cfg = self.config
        self.opt_state, self.adv_norm, metrics = _marwil_iteration(
            self.tx, cfg, self._v_mu, self._v_sd, self.params,
            self.opt_state, self.adv_norm, self.data, self.targets(),
            self._draws())
        return self._finish(metrics)

    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["adv_norm"] = float(self.adv_norm)
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        self.adv_norm = torch.tensor(float(state["adv_norm"]),
                                     dtype=torch.float32).to(self.device)


def marwil_value(params, obs, mu, sd):
    """Value read-out: the net predicts in return-normalized space."""
    return mu + sd * apply_mlp(params["value"], obs).squeeze(-1)


def _reverse_scans(r, d, trunc, v, v_next, gamma, lam, use_gae):
    """The JAX package's two reverse ``lax.scan``s in float32 numpy, in
    its order: returns to go bootstrapping ``v_next`` where an episode
    was cut by the time limit (and at the log's end), and GAE(lambda)
    (or ``rtg - v``)."""
    f = np.float32
    g = f(gamma)
    boot = trunc * v_next
    rtg = np.empty_like(r)
    acc = v_next[-1]
    for t in range(len(r) - 1, -1, -1):
        acc = r[t] + g * (boot[t] if d[t] > 0 else acc)
        rtg[t] = acc
    if not use_gae:
        return rtg, rtg - v
    # Only TRUE terminals zero the next-state value; the accumulation
    # itself stops at every episode boundary.
    term = d * (f(1.0) - trunc)
    delta = r + g * (f(1.0) - term) * v_next - v
    gl = f(gamma * lam)
    adv = np.empty_like(r)
    acc = f(0.0)
    for t in range(len(r) - 1, -1, -1):
        acc = delta[t] + gl * (f(1.0) - d[t]) * acc
        adv[t] = acc
    return rtg, adv


@torch.no_grad()
def marwil_targets(params, data, host, gamma, lam, use_gae, mu, sd):
    """(rtg, adv) over the sequentially logged episodes, as device
    tensors: V and V(next_obs) on the device (one copy back), the
    recurrences on the host."""
    v = marwil_value(params, data["obs"], mu, sd)
    v_next = marwil_value(params, data["next_obs"], mu, sd)
    v, v_next = torch.stack([v, v_next]).cpu().numpy()
    rtg, adv = _reverse_scans(host["reward"], host["done"],
                              host["truncated"], v, v_next, gamma, lam,
                              use_gae)
    dev = data["obs"].device
    return (torch.from_numpy(rtg).to(dev), torch.from_numpy(adv).to(dev))


def marwil_loss(cfg, mu, sd, p, mb, c):
    """Value regression in normalized-return space plus exp-weighted
    cloning; aux (vf_loss, clone, the new moving E[A²])."""
    v_n = apply_mlp(p["value"], mb["obs"]).squeeze(-1)
    adv = mb["adv"]
    vf_loss = torch.mean((v_n - (mb["ret"] - mu) / sd) ** 2)
    w = torch.exp(torch.clamp(cfg.beta * adv / torch.sqrt(c + 1e-8),
                              -5.0, 5.0))
    w = w / torch.clamp_min(torch.mean(w), 1e-8)
    a_mu, _ = _actor_dist(p["actor"], mb["obs"])
    pred = torch.tanh(a_mu) * cfg.action_scale
    clone = torch.mean(w.detach()
                       * torch.sum((pred - mb["action"]) ** 2, -1))
    total = clone + cfg.vf_coeff * vf_loss
    rate = cfg.moving_average_sqd_adv_norm_update_rate
    new_c = (1 - rate) * c + rate * torch.mean(adv ** 2)
    return total, {"vf_loss": vf_loss, "clone": clone, "c": new_c}


def _marwil_iteration(tx, cfg, mu, sd, params, opt_state, adv_norm, data,
                      targets, draws):
    """One update per row of ``draws["idx"]`` on the iteration's
    ``targets`` (rtg, adv); params updated in place.  Returns (opt_state,
    adv_norm, metrics)."""
    ret, adv_all = targets
    c, rows = adv_norm, []
    for idx in draws["idx"]:
        mb = {"obs": data["obs"][idx], "action": data["action"][idx],
              "ret": ret[idx], "adv": adv_all[idx]}
        opt_state, loss, aux, _ = apply_gradients(
            tx, params, opt_state,
            lambda p: marwil_loss(cfg, mu, sd, p, mb, c))
        c = aux["c"]
        rows.append({"total_loss": loss, "vf_loss": aux["vf_loss"],
                     "weighted_clone_loss": aux["clone"]})
    return opt_state, c, _means(rows)

