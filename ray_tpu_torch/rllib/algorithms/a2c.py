"""A2C — synchronous advantage actor-critic (port of
``ray_tpu/rllib/algorithms/a2c.py``).

PPO's machinery minus the clipped surrogate: a rollout, GAE (lam 1 by
default: plain n-step returns) and a single unclipped policy-gradient
step on the whole batch.  PPO's setup, serving and state surface are
reused; only the iteration differs.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib import sampler
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.pg import flat
from ray_tpu_torch.rllib.algorithms.ppo import PPO
from ray_tpu_torch.rllib.learner import apply_gradients


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 7e-4
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.lambda_ = 1.0           # plain n-step returns by default
        self.grad_clip = 0.5

    @property
    def algo_class(self):
        return A2C


class A2C(PPO):
    config_class = A2CConfig

    def _draws(self):
        cfg = self.config
        return sampler.draw_rollout(self.env, self.net, self._gen,
                                    cfg.num_envs, cfg.rollout_length,
                                    self.device)

    def _iteration(self, draws):
        cfg = self.config
        scfg = (cfg.rollout_length, cfg.vf_loss_coeff, cfg.entropy_coeff,
                cfg.gamma, cfg.lambda_)
        return _a2c_iteration(self.env, self.net, self.tx, scfg, self.params,
                              self.opt_state, self.env_state, self.obs,
                              self.ep_ret, self.ep_len, draws)


def a2c_loss(net, vf_coef, ent_coef, p, b_obs, b_act, b_adv, b_ret):
    dist = net.action_dist(p, b_obs)
    logp = dist.log_prob(b_act)
    pg_loss = -torch.mean(logp * b_adv)
    value = net.value(p, b_obs)
    vf_loss = torch.mean((value - b_ret) ** 2)
    entropy = torch.mean(dist.entropy())
    total = pg_loss + vf_coef * vf_loss - ent_coef * entropy
    return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


def _a2c_iteration(env, net, tx, scfg, params, opt_state, env_state, obs,
                   ep_ret, ep_len, draws):
    """One iteration on ``draws``; ``params`` updated in place.  Returns
    (opt_state, env_state, obs, ep_ret, ep_len, metrics)."""
    T, vf_coef, ent_coef, gamma, lam = scfg
    env_state, obs, ep_ret, ep_len, roll = sampler.unroll(
        env, net, params, env_state, obs, ep_ret, ep_len, T, draws)
    advs, returns = sampler.gae(
        roll.reward, roll.done, roll.value, roll.last_value,
        gamma=gamma, lam=lam, terminal=roll.terminal,
        next_value=roll.next_value)
    opt_state, loss, aux, _ = apply_gradients(
        tx, params, opt_state,
        lambda p: a2c_loss(net, vf_coef, ent_coef, p, flat(roll.obs),
                           flat(roll.action), flat(advs), flat(returns)))
    metrics = {"total_loss": loss, **aux, **sampler.episode_stats(roll)}
    return opt_state, env_state, obs, ep_ret, ep_len, metrics
