"""PPO — proximal policy optimization (port of
``ray_tpu/rllib/algorithms/ppo.py``).

The same loss (clipped surrogate, clipped value loss, entropy bonus,
per-minibatch advantage normalization) and iteration: a rollout on the
device, GAE, then ``num_epochs`` passes of minibatch SGD, each over a
fresh permutation of the flattened batch.  The rollout's draws and the
epochs' permutations are made first and passed in.
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
from ray_tpu_torch.rllib.algorithms.pg import flat, setup_on_policy
from ray_tpu_torch.rllib.learner import apply_gradients


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.num_epochs = 4
        self.num_minibatches = 4
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.lambda_ = 0.95
        self.grad_clip = 0.5
        self.normalize_advantages = True

    @property
    def algo_class(self):
        return PPO


class PPO(Algorithm):
    config_class = PPOConfig

    def _setup(self) -> None:
        setup_on_policy(self)

    def _draws(self):
        """The rollout's draws and one permutation of the batch an
        epoch."""
        cfg = self.config
        draws = sampler.draw_rollout(self.env, self.net, self._gen,
                                     cfg.num_envs, cfg.rollout_length,
                                     self.device)
        n = cfg.num_envs * cfg.rollout_length
        draws["perms"] = torch.stack([
            torch.randperm(n, generator=self._gen)
            for _ in range(cfg.num_epochs)]).to(self.device)
        return draws

    def _iteration(self, draws):
        return _ppo_iteration(
            self.env, self.net, self.tx, _static_cfg(self.config),
            self.params, self.opt_state, self.env_state, self.obs,
            self.ep_ret, self.ep_len, draws)

    def _train_once(self) -> Dict[str, Any]:
        (self.opt_state, self.env_state, self.obs, self.ep_ret, self.ep_len,
         metrics) = self._iteration(self._draws())
        out = scalars(metrics)
        out["_timesteps"] = self.config.num_envs * self.config.rollout_length
        return out

    def compute_single_action(self, obs, explore: bool = False):
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            if explore:
                noise = self.net.draw(self._gen, tuple(obs.shape[:-1])
                                      + (self.net.act_dim,))
                a, _ = self.net.sample_action(self.params, obs,
                                              noise.to(self.device))
            else:
                a = self.net.action_dist(self.params, obs).mode()
        return a.cpu().numpy()

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        env = self.env
        rets = []
        gen = torch.Generator().manual_seed(self.config.seed + 1)
        with torch.no_grad():
            for _ in range(num_episodes):
                state, obs = env.reset(env.draw_reset(gen, 1).to(self.device))
                total, done = 0.0, False
                while not done:
                    a = self.net.action_dist(self.params, obs).mode()
                    state, obs, r, d = env.step(state, a)
                    total += float(r[0])
                    done = bool(d[0])
                rets.append(total)
        return {"evaluation_episode_return_mean": float(np.mean(rets))}

    def get_state(self) -> Dict[str, Any]:
        return {
            "params": to_host(self.params),
            "opt_state": to_host(self.opt_state),
            "iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "config": self.config.to_dict(),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = to_device(state["params"], self.device, grad=True)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]


def _static_cfg(cfg: PPOConfig):
    return (cfg.rollout_length, cfg.num_epochs, cfg.num_minibatches,
            cfg.clip_param, cfg.vf_clip_param, cfg.vf_loss_coeff,
            cfg.entropy_coeff, cfg.gamma, cfg.lambda_,
            cfg.normalize_advantages)


def ppo_loss(net, scfg, p, mb):
    (_, _, _, clip, vf_clip, vf_coef, ent_coef, _, _, norm_adv) = scfg
    dist = net.action_dist(p, mb["obs"])
    logp = dist.log_prob(mb["action"])
    ratio = torch.exp(logp - mb["log_prob"])
    adv = mb["adv"]
    if norm_adv:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1 - clip, 1 + clip) * adv
    pg_loss = -torch.mean(torch.minimum(pg1, pg2))
    v = net.value(p, mb["obs"])
    v_clipped = mb["value"] + torch.clamp(v - mb["value"], -vf_clip, vf_clip)
    vf_loss = 0.5 * torch.mean(
        torch.maximum((v - mb["ret"]) ** 2, (v_clipped - mb["ret"]) ** 2))
    entropy = torch.mean(dist.entropy())
    total = pg_loss + vf_coef * vf_loss - ent_coef * entropy
    kl = torch.mean(mb["log_prob"] - logp)
    return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                   "entropy": entropy, "kl": kl}


def _ppo_iteration(env, net, tx, scfg, params, opt_state, env_state, obs,
                   ep_ret, ep_len, draws):
    """One iteration on ``draws`` (the rollout's and ``perms`` [epochs,
    T·N]); ``params`` updated in place.  Returns (opt_state, env_state,
    obs, ep_ret, ep_len, metrics)."""
    (T, num_epochs, num_minibatches, _, _, _, _, gamma, lam, _) = scfg
    env_state, obs, ep_ret, ep_len, roll = sampler.unroll(
        env, net, params, env_state, obs, ep_ret, ep_len, T, draws)
    advs, returns = sampler.gae(
        roll.reward, roll.done, roll.value, roll.last_value,
        gamma=gamma, lam=lam, terminal=roll.terminal,
        next_value=roll.next_value)
    batch = {"obs": flat(roll.obs), "action": flat(roll.action),
             "log_prob": flat(roll.log_prob), "value": flat(roll.value),
             "adv": flat(advs), "ret": flat(returns)}
    n = batch["obs"].shape[0]
    mb_size = n // num_minibatches
    losses, auxes = [], []
    for epoch in range(num_epochs):
        idxs = draws["perms"][epoch][: mb_size * num_minibatches].reshape(
            num_minibatches, mb_size)
        for idx in idxs:
            mb = {k: v[idx] for k, v in batch.items()}
            opt_state, loss, aux, _ = apply_gradients(
                tx, params, opt_state, lambda p: ppo_loss(net, scfg, p, mb))
            losses.append(loss)
            auxes.append(aux)
    metrics = sampler.episode_stats(roll)
    metrics["total_loss"] = torch.stack(losses).mean()
    for k in auxes[0]:
        metrics[k] = torch.stack([a[k] for a in auxes]).mean()
    return opt_state, env_state, obs, ep_ret, ep_len, metrics
