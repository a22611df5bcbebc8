"""SAC — soft actor-critic for continuous control (port of
``ray_tpu/rllib/algorithms/sac.py``).

Twin Q critics with Polyak target networks, a tanh-squashed Gaussian
actor and a learned entropy temperature, all under one Adam (optax's
rounding, ``learner.adam``), with the replay buffer on the device.  One
``train()`` iteration is ``steps_per_iteration`` env steps over
``num_envs`` envs, each followed by an update once the buffer holds
``learning_starts`` transitions (every ``train_freq`` steps).  Both
conditions are host integers, so the loop never waits on the device.
The iteration's draws — action noise, resets, the buffer's sample draws
and the two noises of each update's loss — are made first, in one go,
and passed in.  On the card a step and an update each run as one CUDA
graph, captured in the first iteration.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    to_device,
    to_host,
)
from ray_tpu_torch.rllib.algorithms._off_policy import (
    Steps,
    bias_table,
    detach,
    polyak_,
    run_graph,
)
from ray_tpu_torch.rllib.learner import adam, trainable, value_and_grad
from ray_tpu_torch.rllib.models import apply_mlp, init_mlp
from ray_tpu_torch.rllib.replay_buffer import BufferState, DeviceReplayBuffer

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0
# jnp.log(2 * jnp.pi): the log taken in float32.
_LOG_2PI = float(np.log(np.float32(2 * np.pi)))


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.env = "Pendulum-v1"
        self.lr = 3e-4
        self.buffer_capacity = 100_000
        self.learning_starts = 1_000
        self.train_batch_size = 256
        self.train_freq = 1          # env steps (per env) between updates
        self.tau = 0.005             # target-network soft-update rate
        self.init_alpha = 0.1
        self.target_entropy: float = None  # default: -action_size
        self.action_scale: float = None    # default: env.max_torque-ish 1.0
        self.steps_per_iteration = 256
        self.num_envs = 8
        self.hidden = (128, 128)

    @property
    def algo_class(self):
        return SAC


def _actor_dist(params, obs):
    mu, log_std = torch.chunk(apply_mlp(params, obs), 2, dim=-1)
    return mu, torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)


def _sample_squashed(params, obs, eps, scale):
    """tanh-squashed Gaussian sample on the normal draws ``eps`` (the
    mean's shape) and its log-prob (the SAC policy head)."""
    mu, log_std = _actor_dist(params, obs)
    a = torch.tanh(mu + torch.exp(log_std) * eps)
    # log π with the tanh change-of-variables correction.
    logp = (-0.5 * (eps ** 2 + 2 * log_std + _LOG_2PI)).sum(-1)
    logp = logp - torch.log(1 - a ** 2 + 1e-6).sum(-1)
    return a * scale, logp


def _q(params, obs, act):
    return apply_mlp(params, torch.cat([obs, act], dim=-1)).squeeze(-1)


def init_sac_params(gen, obs_dim, act_dim, hidden, init_alpha, device):
    """Actor, twin critics and ``log_alpha``, as the JAX package lays
    them out (draws from ``gen``)."""
    return trainable({
        "actor": init_mlp(gen, obs_dim, hidden, 2 * act_dim,
                          final_scale=0.01, device=device),
        "q1": init_mlp(gen, obs_dim + act_dim, hidden, 1, final_scale=1.0,
                       device=device),
        "q2": init_mlp(gen, obs_dim + act_dim, hidden, 1, final_scale=1.0,
                       device=device),
        "log_alpha": torch.log(torch.tensor(float(init_alpha))).to(device),
    })


def transition_specs(obs_dim: int, act_dim: int):
    return {"obs": ((obs_dim,), torch.float32),
            "action": ((act_dim,), torch.float32),
            "reward": ((), torch.float32),
            "next_obs": ((obs_dim,), torch.float32),
            "done": ((), torch.float32)}


class SAC(Algorithm):
    config_class = SACConfig

    def _setup(self) -> None:
        cfg, env, dev = self.config, self.env, self.device
        if env.discrete:
            raise ValueError("SAC here targets continuous action spaces "
                             "(use DQN/PPO for discrete)")
        obs_dim, act_dim = env.observation_size, env.action_size
        if cfg.target_entropy is None:
            cfg.target_entropy = -float(act_dim)
        if cfg.action_scale is None:
            cfg.action_scale = float(getattr(env, "max_torque", 1.0))
        self.params = init_sac_params(self._gen, obs_dim, act_dim,
                                      cfg.hidden, cfg.init_alpha, dev)
        self.target_q = to_device({"q1": self.params["q1"],
                                   "q2": self.params["q2"]}, dev)
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        self.buffer = DeviceReplayBuffer(
            cfg.buffer_capacity, transition_specs(obs_dim, act_dim), dev)
        self.buf_state = self.buffer.init()
        self.env_state, self.obs = env.reset(
            env.draw_reset(self._gen, cfg.num_envs).to(dev))
        self.ep_ret = torch.zeros(cfg.num_envs, device=dev)
        self.total_env_steps = 0
        # The steps' CUDA graphs, captured in the first iteration on the
        # card and replayed after (they hold this state's tensors).
        self._graphs = {} if dev.type == "cuda" else None

    def _draws(self) -> Dict[str, torch.Tensor]:
        cfg, env, g = self.config, self.env, self._gen
        T, n, B = cfg.steps_per_iteration, cfg.num_envs, cfg.train_batch_size
        A = env.action_size
        draws = {"action": torch.randn((T, n, A), generator=g),
                 "reset": env.draw_reset(g, n, (T,)),
                 "sample": self.buffer.draw(g, B, (T,)),
                 "loss": torch.randn((T, 2, B, A), generator=g)}
        return {k: v.to(self.device) for k, v in draws.items()}

    def _train_once(self) -> Dict[str, Any]:
        (self.opt_state, self.buf_state, self.total_env_steps,
         metrics) = _sac_iteration(
            self.env, self.buffer, self.tx, self.config, self.params,
            self.target_q, self.opt_state, self.buf_state, self.env_state,
            self.obs, self.ep_ret, self.total_env_steps, self._draws(),
            self._graphs)
        out = dict(metrics)
        out["_timesteps"] = (self.config.steps_per_iteration
                             * self.config.num_envs)
        return out

    def compute_single_action(self, obs, explore: bool = False):
        cfg = self.config
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)[None]
        with torch.no_grad():
            if explore:
                eps = torch.randn((1, self.env.action_size),
                                  generator=self._gen).to(self.device)
                a, _ = _sample_squashed(self.params["actor"], obs, eps,
                                        cfg.action_scale)
                return a[0].cpu().numpy()
            mu, _ = _actor_dist(self.params["actor"], obs)
            return (torch.tanh(mu[0]) * cfg.action_scale).cpu().numpy()

    def get_state(self) -> Dict[str, Any]:
        return {
            "params": to_host(self.params),
            "target_q": to_host(self.target_q),
            "opt_state": to_host(self.opt_state),
            "iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "total_env_steps": self.total_env_steps,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = to_device(state["params"], self.device, grad=True)
        self.target_q = to_device(state["target_q"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]
        self.total_env_steps = int(state["total_env_steps"])
        if self._graphs is not None:
            self._graphs = {}  # they hold the replaced tensors


def sac_losses(gamma, scale, target_entropy, p, tq, mb, e_next, e_pi):
    """Critic + actor + temperature loss on the normal draws ``e_next``
    (the target's action at s') and ``e_pi`` (the actor's at s); JAX's
    ``stop_gradient`` points are the ``no_grad`` target, the detached
    critics and alpha of the actor term and the detached entropy gap of
    the temperature term."""
    alpha = torch.exp(p["log_alpha"])
    with torch.no_grad():
        # Critic target from the CURRENT policy at s'.
        a_next, logp_next = _sample_squashed(p["actor"], mb["next_obs"],
                                             e_next, scale)
        q_next = torch.minimum(_q(tq["q1"], mb["next_obs"], a_next),
                               _q(tq["q2"], mb["next_obs"], a_next)
                               ) - alpha * logp_next
        target = mb["reward"] + gamma * (1 - mb["done"]) * q_next
    q1 = _q(p["q1"], mb["obs"], mb["action"])
    q2 = _q(p["q2"], mb["obs"], mb["action"])
    critic_loss = (torch.mean((q1 - target) ** 2)
                   + torch.mean((q2 - target) ** 2))
    # Actor: maximize min-Q minus entropy penalty (critics frozen).
    a_pi, logp_pi = _sample_squashed(p["actor"], mb["obs"], e_pi, scale)
    q_pi = torch.minimum(_q(detach(p["q1"]), mb["obs"], a_pi),
                         _q(detach(p["q2"]), mb["obs"], a_pi))
    actor_loss = torch.mean(alpha.detach() * logp_pi - q_pi)
    # Temperature: drive entropy to the target.
    alpha_loss = -torch.mean(p["log_alpha"]
                             * (logp_pi + target_entropy).detach())
    total = critic_loss + actor_loss + alpha_loss
    return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                   "alpha": alpha, "entropy": -torch.mean(logp_pi)}


class _Steps(Steps):
    """SAC's ``act`` (a squashed-Gaussian action per env, then the env
    step) and ``learn`` (a sample, the loss, the Adam update, the Polyak
    step), reading their draws and Adam's bias corrections through device
    counters."""

    def __init__(self, tx, cfg, params, target_q, opt_state, *args):
        super().__init__(*args)
        dev = self.obs.device
        self.tx, self.cfg = tx, cfg
        self.params, self.target_q = params, target_q
        self.opt_state = opt_state
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.bias = torch.zeros((cfg.steps_per_iteration, 2), device=dev)
        self.closs_sum = torch.zeros((), device=dev)
        self.ent_sum = torch.zeros((), device=dev)
        self.alpha = torch.zeros((), device=dev)

    def begin(self, draws, buf_state, opt_state) -> None:
        super().begin(draws, buf_state.ptr, buf_state.size)
        self.opt_state = opt_state
        self.bias.copy_(bias_table(self.tx, opt_state["count"],
                                   self.cfg.steps_per_iteration,
                                   self.bias.device))
        for x in (self.k, self.closs_sum, self.ent_sum):
            x.zero_()

    def act(self) -> None:
        with torch.no_grad():
            action, _ = _sample_squashed(self.params["actor"], self.obs,
                                         self.row("action"),
                                         self.cfg.action_scale)
        self.step_env(action)

    def learn(self) -> None:
        cfg = self.cfg
        noise = self.row("loss", back=1)
        # Fresh leaves over the params' storage: their autograd nodes
        # belong to the stream this runs on, which a capture needs.
        (_, aux), grads = value_and_grad(
            lambda p: sac_losses(cfg.gamma, cfg.action_scale,
                                 cfg.target_entropy, p, self.target_q,
                                 self.sample(), noise[0], noise[1]),
            trainable(self.params))
        bias = self.bias.index_select(0, self.k)[0]
        self.tx.update_(self.params, grads, self.opt_state,
                        bias=(bias[0], bias[1]))
        polyak_(self.target_q, {"q1": self.params["q1"],
                                "q2": self.params["q2"]}, cfg.tau)
        self.k.add_(1)
        self.closs_sum.add_(aux["critic_loss"].detach())
        self.ent_sum.add_(aux["entropy"].detach())
        self.alpha.copy_(aux["alpha"].detach())


def _sac_iteration(env, buffer, tx, cfg, params, target_q, opt_state,
                   buf_state, env_state, obs, ep_ret, total_steps: int,
                   draws, graphs=None):
    """``cfg.steps_per_iteration`` env steps on ``draws`` (see
    ``SAC._draws``); params, targets, moments, the buffer and the env
    state are updated in place.  With ``graphs`` (a dict kept across
    iterations, on the card) the steps run as CUDA graphs.  Returns
    (opt_state, buf_state, total_steps, metrics)."""
    T, n = cfg.steps_per_iteration, obs.shape[0]
    steps = graphs.get("steps") if graphs is not None else None
    if steps is None:
        steps = _Steps(tx, cfg, params, target_q, opt_state, env, buffer,
                       buf_state, env_state, obs, ep_ret, draws)
        if graphs is not None:
            graphs["steps"] = steps
    steps.begin(draws, buf_state, opt_state)
    train_every = max(cfg.train_freq, 1)
    ptr, filled, updates, last = buf_state.ptr, buf_state.size, 0, False
    for _ in range(T):
        run_graph(graphs, "act", steps.act)
        total_steps += n
        ptr, filled = (ptr + n) % buffer.capacity, min(filled + n,
                                                       buffer.capacity)
        last = (filled >= cfg.learning_starts
                and (total_steps // n) % train_every == 0)
        if last:
            run_graph(graphs, "learn", steps.learn)
            updates += 1
    opt_state = dict(opt_state, count=opt_state["count"] + updates)
    # alpha is the last step's: the updated step's (before its update),
    # else the current temperature.
    alpha = (steps.alpha if last
             else torch.exp(params["log_alpha"].detach()))
    closs, ent, alpha = (torch.stack([steps.closs_sum / T, steps.ent_sum / T,
                                      alpha]).tolist())
    metrics = {"episode_return_mean": steps.episode_return(),
               "critic_loss_mean": closs, "alpha": alpha, "entropy": ent,
               "buffer_size": float(filled)}
    return (opt_state, BufferState(buf_state.data, ptr, filled),
            total_steps, metrics)
