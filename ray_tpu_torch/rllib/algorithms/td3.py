"""TD3 — twin-delayed DDPG for continuous control (port of
``ray_tpu/rllib/algorithms/td3.py``).

A deterministic actor, twin Q critics with a min-backup, target-policy
smoothing noise and delayed actor updates, with the replay buffer on the
device.  The actor and the critics have an Adam each (one shared Adam
would keep nudging the actor from retained momentum on critic-only
steps).  An update first steps the critics, then, every
``policy_delay``-th env step, the actor on the UPDATED first critic,
then moves the whole target tree.  Until ``learning_starts`` env steps
have been taken the actions are uniform.  Every condition is a host
integer; the iteration's draws (exploration noise, warm-up uniforms,
resets, the buffer's sample draws, the target smoothing noise) are made
first, in one go.  On the card a step and each kind of update run as CUDA
graphs.
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
from ray_tpu_torch.rllib.algorithms.sac import _q, transition_specs
from ray_tpu_torch.rllib.env import _uniform
from ray_tpu_torch.rllib.learner import adam, trainable, value_and_grad
from ray_tpu_torch.rllib.models import apply_mlp, init_mlp
from ray_tpu_torch.rllib.replay_buffer import BufferState, DeviceReplayBuffer


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.env = "Pendulum-v1"
        self.lr = 3e-4
        self.buffer_capacity = 100_000
        self.learning_starts = 1_000
        self.train_batch_size = 256
        self.tau = 0.005
        self.exploration_noise = 0.1       # σ of behavior noise
        self.target_noise = 0.2            # smoothing σ on target action
        self.noise_clip = 0.5
        self.policy_delay = 2              # critic updates per actor update
        self.twin_q = True                 # False → plain DDPG backup
        self.action_scale: float = None
        self.steps_per_iteration = 256
        self.num_envs = 8
        self.hidden = (128, 128)

    @property
    def algo_class(self):
        return TD3


def _pi(params, obs, scale):
    return torch.tanh(apply_mlp(params, obs)) * scale


def _critics(params):
    return {k: v for k, v in params.items() if k != "actor"}


class TD3(Algorithm):
    config_class = TD3Config

    def _setup(self) -> None:
        cfg, env, dev = self.config, self.env, self.device
        if env.discrete:
            raise ValueError("TD3 targets continuous action spaces")
        obs_dim, act_dim = env.observation_size, env.action_size
        if cfg.action_scale is None:
            cfg.action_scale = float(getattr(env, "max_torque", 1.0))
        g = self._gen
        params = {
            "actor": init_mlp(g, obs_dim, cfg.hidden, act_dim,
                              final_scale=0.01, device=dev),
            "q1": init_mlp(g, obs_dim + act_dim, cfg.hidden, 1,
                           final_scale=1.0, device=dev),
        }
        if cfg.twin_q:
            params["q2"] = init_mlp(g, obs_dim + act_dim, cfg.hidden, 1,
                                    final_scale=1.0, device=dev)
        self.params = trainable(params)
        self.target = to_device(self.params, dev)
        self.tx_actor = adam(cfg.lr)
        self.tx_critic = adam(cfg.lr)
        self.opt_state = (self.tx_actor.init(self.params["actor"]),
                          self.tx_critic.init(_critics(self.params)))
        self.buffer = DeviceReplayBuffer(
            cfg.buffer_capacity, transition_specs(obs_dim, act_dim), dev)
        self.buf_state = self.buffer.init()
        self.env_state, self.obs = env.reset(
            env.draw_reset(g, cfg.num_envs).to(dev))
        self.ep_ret = torch.zeros(cfg.num_envs, device=dev)
        self.total_env_steps = 0
        self._graphs = {} if dev.type == "cuda" else None

    def _draws(self) -> Dict[str, torch.Tensor]:
        cfg, env, g = self.config, self.env, self._gen
        T, n, B = cfg.steps_per_iteration, cfg.num_envs, cfg.train_batch_size
        A = env.action_size
        draws = {"explore": torch.randn((T, n, A), generator=g),
                 "warm": torch.rand((T, n, A), generator=g),
                 "reset": env.draw_reset(g, n, (T,)),
                 "sample": self.buffer.draw(g, B, (T,)),
                 "target": torch.randn((T, B, A), generator=g)}
        return {k: v.to(self.device) for k, v in draws.items()}

    def _train_once(self) -> Dict[str, Any]:
        (self.opt_state, self.buf_state, self.total_env_steps,
         metrics) = _td3_iteration(
            self.env, self.buffer, (self.tx_actor, self.tx_critic),
            self.config, self.params, self.target, self.opt_state,
            self.buf_state, self.env_state, self.obs, self.ep_ret,
            self.total_env_steps, self._draws(), self._graphs)
        out = dict(metrics)
        out["_timesteps"] = (self.config.steps_per_iteration
                             * self.config.num_envs)
        return out

    def compute_single_action(self, obs, explore: bool = False):
        cfg = self.config
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)[None]
        with torch.no_grad():
            a = _pi(self.params["actor"], obs, cfg.action_scale)[0]
            if explore:
                noise = torch.randn(a.shape, generator=self._gen)
                a = a + cfg.exploration_noise * cfg.action_scale \
                    * noise.to(self.device)
                a = torch.clamp(a, -cfg.action_scale, cfg.action_scale)
        return a.cpu().numpy()

    def get_state(self) -> Dict[str, Any]:
        return {
            "params": to_host(self.params),
            "target": to_host(self.target),
            "opt_state": to_host(self.opt_state),
            "iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "total_env_steps": self.total_env_steps,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = to_device(state["params"], self.device, grad=True)
        self.target = to_device(state["target"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]
        self.total_env_steps = int(state["total_env_steps"])
        if self._graphs is not None:
            self._graphs = {}  # they hold the replaced tensors


def critic_loss(cfg, q_params, tgt, mb, noise):
    """Both critics' TD loss to the smoothed, min-backed-up target
    (``noise``: the standard normal smoothing draws)."""
    scale = cfg.action_scale
    with torch.no_grad():
        noise = torch.clamp(cfg.target_noise * scale * noise,
                            -cfg.noise_clip * scale, cfg.noise_clip * scale)
        a_next = torch.clamp(_pi(tgt["actor"], mb["next_obs"], scale) + noise,
                             -scale, scale)
        q_next = _q(tgt["q1"], mb["next_obs"], a_next)
        if cfg.twin_q:
            q_next = torch.minimum(q_next,
                                   _q(tgt["q2"], mb["next_obs"], a_next))
        y = mb["reward"] + cfg.gamma * (1 - mb["done"]) * q_next
    loss = torch.mean((_q(q_params["q1"], mb["obs"], mb["action"]) - y) ** 2)
    if cfg.twin_q:
        loss = loss + torch.mean(
            (_q(q_params["q2"], mb["obs"], mb["action"]) - y) ** 2)
    return loss, {}


def actor_loss(cfg, actor_params, q1_params, mb):
    a_pi = _pi(actor_params, mb["obs"], cfg.action_scale)
    return -torch.mean(_q(q1_params, mb["obs"], a_pi)), {}


class _Steps(Steps):
    """TD3's ``act`` (the noisy or warm-up action, then the env step) and
    ``learn`` (a sample, the critics' update, the actor's when asked, the
    Polyak step).  The actor and critic Adams have a counter and a table
    of bias corrections each; ``warm`` holds each step's warm-up flag."""

    def __init__(self, txs, cfg, params, target, opt_state, *args):
        super().__init__(*args)
        dev = self.obs.device
        T = cfg.steps_per_iteration
        self.txs, self.cfg = txs, cfg
        self.params, self.target, self.opt_state = params, target, opt_state
        self.ka = torch.zeros((), dtype=torch.int64, device=dev)
        self.kc = torch.zeros((), dtype=torch.int64, device=dev)
        self.bias = torch.zeros((2, T, 2), device=dev)
        self.warm = torch.zeros((T,), dtype=torch.bool, device=dev)
        self.closs_sum = torch.zeros((), device=dev)

    def begin(self, draws, buf_state, opt_state, total_steps: int) -> None:
        super().begin(draws, buf_state.ptr, buf_state.size)
        cfg, T, n = self.cfg, self.cfg.steps_per_iteration, self.obs.shape[0]
        self.opt_state = opt_state
        for i, (tx, st) in enumerate(zip(self.txs, opt_state)):
            self.bias[i].copy_(bias_table(tx, st["count"], T,
                                          self.bias.device))
        # Warm-up: until the buffer can serve its first update the actor
        # is untrained and σ-noise around it barely covers the action
        # space — act uniformly instead.
        self.warm.copy_(torch.tensor(
            [total_steps + t * n < cfg.learning_starts for t in range(T)]))
        for x in (self.ka, self.kc, self.closs_sum):
            x.zero_()

    def act(self) -> None:
        scale = self.cfg.action_scale
        with torch.no_grad():
            a = _pi(self.params["actor"], self.obs, scale)
            a = torch.clamp(a + self.cfg.exploration_noise * scale
                            * self.row("explore"), -scale, scale)
            a = torch.where(self.warm.index_select(0, self.t),
                            _uniform(self.row("warm"), -scale, scale), a)
        self.step_env(a)

    def learn(self, update_actor: bool) -> None:
        cfg, (tx_actor, tx_critic) = self.cfg, self.txs
        actor_opt, critic_opt = self.opt_state
        mb = self.sample()
        noise = self.row("target", back=1)
        qp = _critics(self.params)
        (closs, _), cgrads = value_and_grad(
            lambda q: critic_loss(cfg, q, self.target, mb, noise),
            trainable(qp))
        bias = self.bias[1].index_select(0, self.kc)[0]
        tx_critic.update_(qp, cgrads, critic_opt, bias=(bias[0], bias[1]))
        self.kc.add_(1)
        if update_actor:
            _, agrads = value_and_grad(
                lambda a: actor_loss(cfg, a, detach(self.params["q1"]), mb),
                trainable(self.params["actor"]))
            bias = self.bias[0].index_select(0, self.ka)[0]
            tx_actor.update_(self.params["actor"], agrads, actor_opt,
                             bias=(bias[0], bias[1]))
            self.ka.add_(1)
        polyak_(self.target, self.params, cfg.tau)
        self.closs_sum.add_(closs.detach())


def _td3_iteration(env, buffer, txs, cfg, params, target, opt_state,
                   buf_state, env_state, obs, ep_ret, total_steps: int,
                   draws, graphs=None):
    """``cfg.steps_per_iteration`` env steps on ``draws`` (see
    ``TD3._draws``); params, targets, moments, the buffer and the env
    state are updated in place.  With ``graphs`` (a dict kept across
    iterations, on the card) the steps run as CUDA graphs.  Returns
    (opt_state, buf_state, total_steps, metrics)."""
    T, n = cfg.steps_per_iteration, obs.shape[0]
    steps = graphs.get("steps") if graphs is not None else None
    if steps is None:
        steps = _Steps(txs, cfg, params, target, opt_state, env, buffer,
                       buf_state, env_state, obs, ep_ret, draws)
        if graphs is not None:
            graphs["steps"] = steps
    steps.begin(draws, buf_state, opt_state, total_steps)
    ptr, filled = buf_state.ptr, buf_state.size
    n_actor = n_critic = 0
    for _ in range(T):
        run_graph(graphs, "act", steps.act)
        total_steps += n
        ptr, filled = (ptr + n) % buffer.capacity, min(filled + n,
                                                       buffer.capacity)
        if filled >= cfg.learning_starts:
            update_actor = (total_steps // n) % cfg.policy_delay == 0
            run_graph(graphs, "learn_actor" if update_actor else "learn",
                      lambda: steps.learn(update_actor))
            n_critic += 1
            n_actor += update_actor
    actor_opt, critic_opt = opt_state
    opt_state = (dict(actor_opt, count=actor_opt["count"] + n_actor),
                 dict(critic_opt, count=critic_opt["count"] + n_critic))
    metrics = {"episode_return_mean": steps.episode_return(),
               "critic_loss_mean": float(steps.closs_sum / T)}
    return (opt_state, BufferState(buf_state.data, ptr, filled),
            total_steps, metrics)
