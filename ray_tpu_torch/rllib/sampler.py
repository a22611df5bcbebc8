"""Trajectory collection on the device (port of
``ray_tpu/rllib/sampler.py``).

``unroll`` steps N batched envs for T steps in a Python loop over
batched tensor ops (the JAX package's ``lax.scan`` over a vmapped
step), auto-resetting finished envs in the same step so shapes never
change.  Its randomness comes in first: ``draw_rollout`` makes the
action noise and reset draws for the whole rollout in one go on a CPU
generator (so a seed gives the same rollout on the CPU and on the card)
and moves them to the device; a test hands in JAX's draws instead.
Also GAE (a reverse loop over T) and episode-return bookkeeping.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ray_tpu_torch.rllib.env import terminal_mask


class Rollout(NamedTuple):
    """Time-major [T, N, ...] trajectory batch (the SampleBatch slot)."""

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    last_value: torch.Tensor      # [N] bootstrap value of the final obs
    episode_return: torch.Tensor  # [T, N] completed returns (NaN elsewhere)
    episode_length: torch.Tensor  # [T, N] completed lengths (0 elsewhere)
    next_obs: torch.Tensor        # [T, N, D] PRE-reset successor obs
    terminal: torch.Tensor        # [T, N] done minus time-limit truncation
    next_value: torch.Tensor      # [T, N] V(next_obs) under rollout params


def draw_rollout(env, net, generator: torch.Generator, n_envs: int,
                 num_steps: int, device) -> Dict[str, torch.Tensor]:
    """``{"action": [T, N, act_dim] noise, "reset": [T, N, ...] uniform
    draws}`` from ``generator``, on ``device``."""
    return {
        "action": net.draw(generator, (num_steps, n_envs, net.act_dim)
                           ).to(device),
        "reset": env.draw_reset(generator, n_envs, (num_steps,)).to(device),
    }


def _where_done(done, reset, cur):
    return torch.where(done.reshape(done.shape + (1,) * (cur.dim()
                                                         - done.dim())),
                       reset, cur)


@torch.no_grad()
def unroll(env, net, params, state, obs, ep_ret, ep_len, num_steps: int,
           draws: Dict[str, torch.Tensor]):
    """Collect ``num_steps`` from N parallel envs with ``draws`` (see
    ``draw_rollout``).  Returns (new_state, new_obs, new_ep_ret,
    new_ep_len, Rollout)."""
    outs = []
    for t in range(num_steps):
        action, log_prob = net.sample_action(params, obs, draws["action"][t])
        value = net.value(params, obs)
        next_state, next_obs, reward, done = env.step(state, action)
        # The TRUE successor, before auto-reset overwrites it: GAE must
        # bootstrap V(next_obs) at time-limit truncations.
        term = terminal_mask(env, next_state, done)
        ep_ret = ep_ret + reward
        ep_len = ep_len + 1
        # record completed episodes at the step they finish
        completed_ret = torch.where(done, ep_ret, float("nan"))
        completed_len = torch.where(done, ep_len, 0)
        ep_ret = torch.where(done, 0.0, ep_ret)
        ep_len = torch.where(done, 0, ep_len)
        reset_state, reset_obs = env.reset(draws["reset"][t])
        outs.append((obs, action, reward, done, log_prob, value,
                     completed_ret, completed_len, next_obs, term))
        state = {k: _where_done(done, reset_state[k], v)
                 for k, v in next_state.items()}
        obs = _where_done(done, reset_obs, next_obs)
    (obs_t, act_t, rew_t, done_t, logp_t, val_t, cret_t, clen_t, nobs_t,
     term_t) = (torch.stack(x) for x in zip(*outs))
    last_value = net.value(params, obs)
    # One batched forward over the stacked [T, N, D] successors.
    nval_t = net.value(params, nobs_t)
    roll = Rollout(obs_t, act_t, rew_t, done_t, logp_t, val_t, last_value,
                   cret_t, clen_t, nobs_t, term_t, nval_t)
    return state, obs, ep_ret, ep_len, roll


def gae(reward, done, value, last_value, *, gamma: float, lam: float,
        terminal=None, next_value=None):
    """Generalized advantage estimation over a [T, N] rollout, a reverse
    loop over T.  The accumulation stops at episode boundaries
    (``done``); with ``terminal``/``next_value`` (from :class:`Rollout`)
    the one-step bootstrap takes V(pre-reset next_obs) at time-limit
    truncations instead of zero.  Without them every ``done`` zeroes the
    bootstrap."""
    not_done = 1.0 - done.to(torch.float32)
    if terminal is None or next_value is None:
        next_values = torch.cat([value[1:], last_value[None]], dim=0)
        deltas = reward + gamma * next_values * not_done - value
    else:
        deltas = (reward
                  + gamma * next_value
                  * (1.0 - terminal.to(torch.float32))
                  - value)
    advs = torch.empty_like(deltas)
    adv = torch.zeros_like(last_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        adv = deltas[t] + gamma * lam * not_done[t] * adv
        advs[t] = adv
    return advs, advs + value


def episode_stats(roll: Rollout) -> Dict[str, torch.Tensor]:
    """Mean completed-episode return/length within the rollout (NaN if
    no episode finished — callers carry the previous value forward)."""
    rets = roll.episode_return
    count = torch.sum(~torch.isnan(rets))
    mean_ret = torch.where(
        count > 0, torch.nansum(rets) / count.clamp_min(1),
        float("nan"))
    lens = roll.episode_length.to(torch.float32)
    mean_len = torch.where(
        count > 0, torch.sum(lens) / count.clamp_min(1), float("nan"))
    return {"episode_return_mean": mean_ret,
            "episode_len_mean": mean_len,
            "episodes_this_iter": count}
