"""Multi-agent environments and independent per-agent PPO learners (port
of ``ray_tpu/rllib/multi_agent.py``).

Agents are a leading tensor axis, not dict keys: per-agent parameters
are one param tree with [A, ...] leaves, and the per-agent forward is
``torch.func.vmap`` over that axis.  Agents share the architecture but
not the weights; each trains on its own rewards only.  Two identities
keep the update a single-learner one:

* Adam is elementwise, so one Adam over the stacked leaves is the JAX
  package's ``vmap(tx.update)`` (one count for all agents, which move
  together).
* The gradient of the SUM of the agents' losses with respect to the
  stacked leaves is, slice by slice, each agent's own gradient.

An iteration's draws — per-agent action noise, ``TwoAgentReach``'s reset
uniforms and one permutation of the T·N batch an epoch — are made first,
in one go, and passed in.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.func import vmap

from ray_tpu_torch.rllib import sampler
from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    to_device,
    to_host,
)
from ray_tpu_torch.rllib.env import (
    _DrawMixin,
    _uniform,
    register_env,
    terminal_mask,
)
from ray_tpu_torch.rllib.learner import adam, apply_gradients, trainable
from ray_tpu_torch.rllib.models import ActorCritic
from ray_tpu_torch.train.state import tree_map


class TwoAgentReach(_DrawMixin):
    """A 2-agent benchmark env, batched: each agent steers its 2-D
    position toward its OWN target while being mildly penalized for
    crowding the other agent (per-agent rewards).  State is ``pos`` and
    ``tgt`` [N, A, 2] and ``t`` [N]; a reset takes [N, 2, A, 2] uniform
    draws (positions, then targets)."""

    n_agents: int = 2
    observation_size: int = 8   # own pos, own target, other pos, other tgt
    action_size: int = 2        # velocity command, clipped
    discrete: bool = False
    max_steps: int = 64
    dt: float = 0.15
    reset_draws = (2, n_agents, 2)

    def reset(self, draws: torch.Tensor):
        state = {"pos": _uniform(draws[..., 0, :, :], -1.0, 1.0),
                 "tgt": _uniform(draws[..., 1, :, :], -1.0, 1.0),
                 "t": torch.zeros(draws.shape[:-3], dtype=torch.int32,
                                  device=draws.device)}
        return state, self._obs(state)

    def _obs(self, state):
        pos, tgt = state["pos"], state["tgt"]
        return torch.cat([pos, tgt, pos.flip(-2), tgt.flip(-2)], dim=-1)

    def step(self, state, action: torch.Tensor):
        """action [N, A, 2] → (state, obs [N, A, D], reward [N, A], done
        [N])."""
        vel = torch.clamp(action, -1.0, 1.0)
        pos = torch.clamp(state["pos"] + self.dt * vel, -1.5, 1.5)
        dist = _norm(pos - state["tgt"])
        crowd = _norm(pos[..., 0, :] - pos[..., 1, :])
        reward = -dist - (0.1 * torch.clamp_min(0.3 - crowd, 0.0))[..., None]
        t = state["t"] + 1
        done = t >= self.max_steps
        new_state = {"pos": pos, "tgt": state["tgt"], "t": t}
        return new_state, self._obs(new_state), reward, done


def _norm(x):
    """``jnp.linalg.norm`` over the last axis: the root of the sum of
    squares."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


register_env("TwoAgentReach", TwoAgentReach)


class MultiAgentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.env = "TwoAgentReach"
        self.num_envs = 16
        self.rollout_length = 64
        self.num_epochs = 4
        self.num_minibatches = 4
        self.clip = 0.2
        self.vf_coef = 0.5
        self.ent_coef = 0.003
        self.gae_lambda = 0.95
        self.lr = 3e-4

    @property
    def algo_class(self):
        return MultiAgentPPO


def stack(trees):
    """Per-agent param trees → one tree of [A, ...] leaves."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


class MultiAgentPPO(Algorithm):
    """Independent PPO over a stacked per-agent param tree."""

    config_class = MultiAgentPPOConfig

    def _setup(self) -> None:
        cfg, env, dev = self.config, self.env, self.device
        A = env.n_agents
        self.net = ActorCritic(env.observation_size, env.action_size,
                               discrete=env.discrete, hidden=cfg.hidden)
        # Each agent from its own draws: genuinely different weights.
        self.params = trainable(stack([self.net.init(self._gen, dev)
                                       for _ in range(A)]))
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        self.env_state, self.obs = env.reset(
            env.draw_reset(self._gen, cfg.num_envs).to(dev))
        self.ep_ret = torch.zeros((cfg.num_envs, A), device=dev)

    def _draws(self) -> Dict[str, torch.Tensor]:
        cfg, env, g = self.config, self.env, self._gen
        T, N, A = cfg.rollout_length, cfg.num_envs, env.n_agents
        n = T * N
        draws = {"action": self.net.draw(g, (T, A, N, env.action_size)),
                 "reset": env.draw_reset(g, N, (T,)),
                 "perms": torch.stack([torch.randperm(n, generator=g)
                                       for _ in range(cfg.num_epochs)])}
        return {k: v.to(self.device) for k, v in draws.items()}

    def _train_once(self) -> Dict[str, Any]:
        self.opt_state, metrics = _ma_ppo_iteration(
            self.env, self.net, self.tx, self.config, self.params,
            self.opt_state, self.env_state, self.obs, self.ep_ret,
            self._draws())
        out: Dict[str, Any] = {}
        for k, v in metrics.items():
            arr = np.asarray(v)
            if arr.ndim == 1:  # per-agent row
                for a in range(arr.shape[0]):
                    out[f"{k}/agent_{a}"] = float(arr[a])
                out[k] = float(np.nanmean(arr))
            else:
                out[k] = float(arr)
        out["_timesteps"] = self.config.rollout_length * self.config.num_envs
        return out

    def compute_actions(self, obs, explore: bool = False):
        """obs [A, D] → action [A, act] (one per agent policy).  Like the
        JAX package's, it samples whatever ``explore`` says."""
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        noise = self.net.draw(self._gen, (obs.shape[0], 1,
                                          self.net.act_dim)).to(self.device)
        with torch.no_grad():
            a, _ = vmap(self.net.sample_action)(self.params, obs[:, None],
                                                noise)
        return a[:, 0].cpu().numpy()

    def get_state(self) -> Dict[str, Any]:
        return {
            "params": to_host(self.params),
            "opt_state": to_host(self.opt_state),
            "iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = to_device(state["params"], self.device, grad=True)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]


def agent_loss(net, cfg, p_a, mb_a):
    """One agent's PPO loss (clipped surrogate, value, entropy) on its
    minibatch, advantages normalised per agent (population std)."""
    dist = net.action_dist(p_a, mb_a["obs"])
    logp = dist.log_prob(mb_a["action"])
    ratio = torch.exp(logp - mb_a["log_prob"])
    adv = mb_a["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.mean(torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv))
    vf = 0.5 * torch.mean((net.value(p_a, mb_a["obs"]) - mb_a["ret"]) ** 2)
    ent = torch.mean(dist.entropy())
    return pg + cfg.vf_coef * vf - cfg.ent_coef * ent


@torch.no_grad()
def _rollout(env, net, params, env_state, obs, ep_ret, T, draws):
    """T steps of N envs, each agent acting through its own slice; the
    env state, obs and returns updated in place.  Returns the [T, N, A,
    ...] rollout and the per-agent return sums and episode count."""
    N, A = obs.shape[0], obs.shape[1]

    def act(p_a, obs_a, noise_a):
        action, logp = net.sample_action(p_a, obs_a, noise_a)
        return action, logp, net.value(p_a, obs_a)

    ret_sum = torch.zeros((A,), device=obs.device)
    ret_cnt = torch.zeros((), dtype=torch.int64, device=obs.device)
    rows = []
    for t in range(T):
        act_t, logp, value = (x.transpose(0, 1) for x in vmap(act)(
            params, obs.transpose(0, 1), draws["action"][t]))  # [N, A, ...]
        next_state, next_obs, reward, done = env.step(env_state, act_t)
        # Pre-reset successor and done-minus-truncation flag for the GAE
        # bootstrap; V(next_obs) runs once batched after the loop.
        term = terminal_mask(env, next_state, done)
        ep = ep_ret + reward
        done_b = done[:, None]
        ret_sum += torch.sum(torch.where(done_b, ep, 0.0), dim=0)
        ret_cnt += torch.sum(done)
        ep_ret.copy_(torch.where(done_b, 0.0, ep))
        r_state, r_obs = env.reset(draws["reset"][t])
        rows.append({"obs": obs.clone(), "action": act_t, "log_prob": logp,
                     "value": value, "reward": reward,
                     "done": done_b.expand(reward.shape),
                     "terminal": term[:, None].expand(reward.shape),
                     "next_obs": next_obs})
        for k, v in env_state.items():
            v.copy_(sampler._where_done(done, r_state[k], next_state[k]))
        obs.copy_(torch.where(done[:, None, None], r_obs, next_obs))
    roll = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    return roll, ret_sum, ret_cnt


def _ma_ppo_iteration(env, net, tx, cfg, params, opt_state, env_state, obs,
                      ep_ret, draws):
    """One iteration on ``draws`` (see ``MultiAgentPPO._draws``); params
    and moments updated in place, the env state, obs and returns too.
    Returns (opt_state, metrics) with per-agent [A] rows."""
    T, N, A = cfg.rollout_length, obs.shape[0], obs.shape[1]
    roll, ret_sum, ret_cnt = _rollout(env, net, params, env_state, obs,
                                      ep_ret, T, draws)
    with torch.no_grad():
        value = vmap(net.value)
        # Bootstrap values per agent at the final obs, and one batched
        # forward per agent over the [T, N, A, D] pre-reset successors.
        last_value = value(params, obs.transpose(0, 1)).transpose(0, 1)
        next_value = value(params, roll["next_obs"].movedim(2, 0)
                           ).movedim(0, 2)
    # GAE is elementwise over the trailing [N, A] axes.
    advs, rets = sampler.gae(roll["reward"], roll["done"], roll["value"],
                             last_value, gamma=cfg.gamma,
                             lam=cfg.gae_lambda, terminal=roll["terminal"],
                             next_value=next_value)
    n = T * N
    batch = {"obs": roll["obs"].reshape(n, A, -1),
             "action": roll["action"].reshape(n, A, -1),
             "log_prob": roll["log_prob"].reshape(n, A),
             "adv": advs.reshape(n, A), "ret": rets.reshape(n, A)}
    mb_size = n // cfg.num_minibatches
    per_agent = vmap(lambda p_a, mb_a: agent_loss(net, cfg, p_a, mb_a))
    losses = []
    for perm in draws["perms"]:
        idxs = perm[: mb_size * cfg.num_minibatches].reshape(
            cfg.num_minibatches, mb_size)
        for idx in idxs:
            mb = {k: v[idx].movedim(1, 0) for k, v in batch.items()}
            opt_state, _, aux, _ = apply_gradients(
                tx, params, opt_state, lambda p: _summed(per_agent(p, mb)))
            losses.append(aux["per_agent"])
    ret_mean = torch.where(ret_cnt > 0, ret_sum / ret_cnt.clamp_min(1),
                           float("nan"))
    rows = torch.stack([ret_mean, torch.stack(losses).mean(0)]).cpu()
    return opt_state, {"episode_return_mean": rows[0].numpy(),
                       "loss": rows[1].numpy()}


def _summed(losses):
    """The sum of the agents' losses (each slice's gradient is its own
    agent's), the per-agent losses as aux."""
    return losses.sum(), {"per_agent": losses}
