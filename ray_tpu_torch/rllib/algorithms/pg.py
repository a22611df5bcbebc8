"""PG — vanilla policy gradient, REINFORCE with a value baseline (port of
``ray_tpu/rllib/algorithms/pg.py``).

One iteration: a rollout of ``rollout_length`` steps over ``num_envs``
envs on the device, Monte-Carlo returns-to-go (GAE with lam = 1, with
the sampler's truncation-aware bootstrap) and one gradient step.  The
iteration's draws are made first (``sampler.draw_rollout``) and passed
in, so a test can run it on JAX's draws.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib import sampler
from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    scalars,
    to_device,
    to_host,
)
from ray_tpu_torch.rllib.learner import adam, apply_gradients, trainable
from ray_tpu_torch.rllib.models import ActorCritic


class PGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.num_envs = 16
        self.rollout_length = 128
        self.lr = 1e-3
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 10.0

    @property
    def algo_class(self):
        return PG


def setup_on_policy(algo: Algorithm) -> None:
    """The actor-critic, its params (init from the algorithm's CPU
    generator), a clipped Adam and ``num_envs`` freshly reset envs on the
    algorithm's device — PG's, PPO's and A2C's setup."""
    cfg, env = algo.config, algo.env
    algo.net = ActorCritic(env.observation_size, env.action_size,
                           discrete=env.discrete, hidden=cfg.hidden)
    algo.params = trainable(algo.net.init(algo._gen, algo.device))
    algo.tx = adam(cfg.lr, cfg.grad_clip)
    algo.opt_state = algo.tx.init(algo.params)
    algo.env_state, algo.obs = env.reset(
        env.draw_reset(algo._gen, cfg.num_envs).to(algo.device))
    algo.ep_ret = torch.zeros(cfg.num_envs, device=algo.device)
    algo.ep_len = torch.zeros(cfg.num_envs, dtype=torch.int32,
                              device=algo.device)


def flat(x: torch.Tensor) -> torch.Tensor:
    """[T, N, ...] → [T·N, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


class PG(Algorithm):
    config_class = PGConfig

    def _setup(self) -> None:
        setup_on_policy(self)

    def _draws(self):
        cfg = self.config
        return sampler.draw_rollout(self.env, self.net, self._gen,
                                    cfg.num_envs, cfg.rollout_length,
                                    self.device)

    def _train_once(self) -> Dict[str, Any]:
        cfg = self.config
        scfg = (cfg.rollout_length, cfg.vf_loss_coeff, cfg.entropy_coeff,
                cfg.gamma)
        (self.opt_state, self.env_state, self.obs, self.ep_ret, self.ep_len,
         metrics) = _pg_iteration(
            self.env, self.net, self.tx, scfg, self.params, self.opt_state,
            self.env_state, self.obs, self.ep_ret, self.ep_len,
            self._draws())
        out = scalars(metrics)
        out["_timesteps"] = cfg.rollout_length * cfg.num_envs
        return out

    def compute_single_action(self, obs, explore: bool = False):
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)[None]
        with torch.no_grad():
            if explore:
                noise = self.net.draw(self._gen, (1, self.net.act_dim))
                a = self.net.sample_action(self.params, obs,
                                           noise.to(self.device))[0][0]
            else:
                a = self.net.action_dist(self.params, obs).mode()[0]
        return int(a) if self.env.discrete else a.cpu().numpy()

    def get_state(self) -> Dict[str, Any]:
        return {"params": to_host(self.params),
                "opt_state": to_host(self.opt_state),
                "iteration": self.iteration,
                "timesteps_total": self._timesteps_total}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = to_device(state["params"], self.device, grad=True)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]


def pg_loss(net, vf_coef, ent_coef, p, b_obs, b_act, b_adv, b_ret):
    dist = net.action_dist(p, b_obs)
    logp = dist.log_prob(b_act)
    pg = -torch.mean(logp * b_adv)
    v = net.value(p, b_obs)
    vf_loss = 0.5 * torch.mean((v - b_ret) ** 2)
    entropy = torch.mean(dist.entropy())
    total = pg + vf_coef * vf_loss - ent_coef * entropy
    return total, {"policy_loss": pg, "vf_loss": vf_loss,
                   "entropy": entropy, "total_loss": total}


def _pg_iteration(env, net, tx, scfg, params, opt_state, env_state, obs,
                  ep_ret, ep_len, draws):
    """One iteration on ``draws``; ``params`` updated in place.  Returns
    (opt_state, env_state, obs, ep_ret, ep_len, metrics)."""
    T, vf_coef, ent_coef, gamma = scfg
    env_state, obs, ep_ret, ep_len, roll = sampler.unroll(
        env, net, params, env_state, obs, ep_ret, ep_len, T, draws)
    advs, returns = sampler.gae(
        roll.reward, roll.done, roll.value, roll.last_value,
        gamma=gamma, lam=1.0, terminal=roll.terminal,
        next_value=roll.next_value)
    b_adv = flat(advs)
    b_adv = (b_adv - b_adv.mean()) / (b_adv.std(correction=0) + 1e-8)
    opt_state, _, aux, _ = apply_gradients(
        tx, params, opt_state,
        lambda p: pg_loss(net, vf_coef, ent_coef, p, flat(roll.obs),
                          flat(roll.action), b_adv, flat(returns)))
    metrics = dict(aux)
    metrics.update(sampler.episode_stats(roll))
    return opt_state, env_state, obs, ep_ret, ep_len, metrics
