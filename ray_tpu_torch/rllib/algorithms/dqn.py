"""DQN — double Q-learning with a replay buffer on the device (port of
``ray_tpu/rllib/algorithms/dqn.py``).

One ``train()`` iteration is ``steps_per_iteration`` env steps over
``num_envs`` envs, each followed by an SGD update once the buffer holds
``learning_starts`` transitions (every ``train_freq // num_envs`` steps)
and a target sync every ``target_update_freq // num_envs`` steps.  Both
conditions depend only on step counts, which the host keeps (the
buffer's fill count is a host integer too), so the loop never waits on
the device.  Dueling heads, prioritized replay and C51 (a categorical
return distribution, with its ``dueling`` refusal) as in the JAX
package.  An iteration's draws — epsilon tests, random actions, resets
and the uniform buffer's sample draws — are made first, in one go; the
prioritized buffer's Gumbel noise is drawn a step at a time on the
device.  On the card, with the uniform buffer, a step and an update each
run as one CUDA graph, captured in the first iteration (an eager step is
some 250 kernel launches, all host-bound at these sizes).
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
)
from ray_tpu_torch.rllib.algorithms._off_policy import run_graph as _run
from ray_tpu_torch.rllib.learner import adam, trainable, value_and_grad
from ray_tpu_torch.rllib.models import (
    c51_support,
    dueling_q_values,
    init_dueling_q_net,
    init_q_net,
    q_values,
)
from ray_tpu_torch.rllib.replay_buffer import (
    BufferState,
    DeviceReplayBuffer,
    PrioritizedDeviceReplayBuffer,
)
from ray_tpu_torch.train.state import tree_leaves


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.buffer_capacity = 50_000
        self.learning_starts = 1_000
        self.train_batch_size = 64
        self.train_freq = 4              # env steps between SGD updates
        self.target_update_freq = 500    # env steps between target syncs
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_steps = 10_000
        self.double_q = True
        self.dueling = False
        self.prioritized_replay = False
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        # Distributional C51: num_atoms > 1 switches the head to a
        # categorical return distribution over a fixed support and the
        # loss to the projected-Bellman cross-entropy.
        self.num_atoms = 1
        self.v_min = 0.0
        self.v_max = 200.0
        self.steps_per_iteration = 1_024
        self.num_envs = 8

    @property
    def algo_class(self):
        return DQN


def epsilon(cfg: DQNConfig, total_steps: int) -> float:
    """The linear schedule in float32, in the JAX package's order."""
    f = np.float32
    e0, e1 = f(cfg.epsilon_start), f(cfg.epsilon_end)
    eps = e0 + f(cfg.epsilon_end - cfg.epsilon_start) * f(total_steps) \
        / f(cfg.epsilon_decay_steps)
    return float(np.clip(eps, e1, e0))


class DQN(Algorithm):
    config_class = DQNConfig

    def _setup(self) -> None:
        cfg = self.config
        env = self.env
        if not env.discrete:
            raise ValueError("DQN requires a discrete action space")
        obs_dim, act_dim = env.observation_size, env.action_size
        dev = self.device
        self._dist_fn = None
        if cfg.num_atoms > 1:
            # C51: Q(s,a) = E_z[p(z|s,a)] over a fixed support.
            if cfg.dueling:
                raise ValueError(
                    "num_atoms > 1 with dueling is not supported — "
                    "pick one head")
            K = cfg.num_atoms
            params = init_q_net(self._gen, obs_dim, act_dim * K, cfg.hidden,
                                device=dev)
            z = c51_support(cfg.v_min, cfg.v_max, K, dev)

            def dist_logits(p, obs):
                out = q_values(p, obs)
                return out.reshape(out.shape[:-1] + (act_dim, K))

            def expected_q(p, obs):
                probs = torch.softmax(dist_logits(p, obs), dim=-1)
                return torch.sum(probs * z, dim=-1)

            self._dist_fn = dist_logits
            self._q_fn = expected_q
        elif cfg.dueling:
            params = init_dueling_q_net(self._gen, obs_dim, act_dim,
                                        cfg.hidden, device=dev)
            self._q_fn = dueling_q_values
        else:
            params = init_q_net(self._gen, obs_dim, act_dim, cfg.hidden,
                                device=dev)
            self._q_fn = q_values
        self.params = trainable(params)
        self.target_params = to_device(self.params, dev)
        self.tx = adam(cfg.lr)
        self.opt_state = self.tx.init(self.params)
        specs = {
            "obs": ((obs_dim,), torch.float32),
            "action": ((), torch.int32),
            "reward": ((), torch.float32),
            "next_obs": ((obs_dim,), torch.float32),
            "done": ((), torch.float32),
        }
        if cfg.prioritized_replay:
            self.buffer = PrioritizedDeviceReplayBuffer(
                cfg.buffer_capacity, specs,
                alpha=cfg.prioritized_replay_alpha,
                beta=cfg.prioritized_replay_beta, device=dev)
        else:
            self.buffer = DeviceReplayBuffer(cfg.buffer_capacity, specs, dev)
        self.buf_state = self.buffer.init()
        self.env_state, self.obs = env.reset(
            env.draw_reset(self._gen, cfg.num_envs).to(dev))
        self.ep_ret = torch.zeros(cfg.num_envs, device=dev)
        self.total_env_steps = 0
        # The prioritized buffer's per-step Gumbel noise (one [capacity]
        # draw an update) is drawn on the device.
        self._dev_gen = torch.Generator(device=dev).manual_seed(
            int(cfg.seed) + 1)
        # The steps' CUDA graphs, captured in the first iteration on the
        # card and replayed after (they hold this state's tensors).
        self._graphs = {} if dev.type == "cuda" else None

    def _draws(self) -> Dict[str, torch.Tensor]:
        cfg, env, g = self.config, self.env, self._gen
        T, n = cfg.steps_per_iteration, cfg.num_envs
        draws = {"eps": torch.rand((T, n), generator=g),
                 "random_action": torch.randint(
                     0, env.action_size, (T, n), generator=g,
                     dtype=torch.int32),
                 "reset": env.draw_reset(g, n, (T,))}
        if not cfg.prioritized_replay:
            draws["sample"] = self.buffer.draw(g, cfg.train_batch_size, (T,))
        return {k: v.to(self.device) for k, v in draws.items()}

    def _train_once(self) -> Dict[str, Any]:
        (self.buf_state, self.env_state, self.obs, self.ep_ret,
         self.total_env_steps, self.opt_state, metrics) = _dqn_iteration(
            self.env, self.buffer, self.tx, self._q_fn, self._dist_fn,
            self.config, self.params, self.target_params, self.opt_state,
            self.buf_state, self.env_state, self.obs, self.ep_ret,
            self.total_env_steps, self._draws(), self._dev_gen,
            self._graphs)
        out = dict(metrics)
        out["_timesteps"] = (self.config.steps_per_iteration
                             * self.config.num_envs)
        return out

    def compute_single_action(self, obs, explore: bool = False):
        cfg = self.config
        if explore:
            eps = epsilon(cfg, self.total_env_steps)
            if float(torch.rand((), generator=self._gen)) < eps:
                return int(torch.randint(0, self.env.action_size, (),
                                         generator=self._gen))
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        with torch.no_grad():
            return int(torch.argmax(self._q_fn(self.params, obs)))

    def get_state(self) -> Dict[str, Any]:
        return {
            "params": to_host(self.params),
            "target_params": to_host(self.target_params),
            "opt_state": to_host(self.opt_state),
            "iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "total_env_steps": self.total_env_steps,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = to_device(state["params"], self.device, grad=True)
        self.target_params = to_device(state["target_params"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]
        self.total_env_steps = int(state["total_env_steps"])
        if self._graphs is not None:
            self._graphs = {}  # they hold the replaced tensors


def td_loss(q_fn, gamma, double_q, p, tp, mb, w):
    """Double-Q (or max-Q) TD loss, weighted by ``w``; aux the TD
    errors."""
    q = q_fn(p, mb["obs"])
    q_taken = torch.gather(q, 1, mb["action"].long()[:, None])[:, 0]
    with torch.no_grad():
        q_next_target = q_fn(tp, mb["next_obs"])
        if double_q:
            a_star = torch.argmax(q_fn(p, mb["next_obs"]), dim=1)
            q_next = torch.gather(q_next_target, 1, a_star[:, None])[:, 0]
        else:
            q_next = torch.max(q_next_target, dim=1).values
        target = mb["reward"] + gamma * (1.0 - mb["done"]) * q_next
    err = q_taken - target
    return torch.mean(w * err ** 2), err


def c51_loss(q_fn, dist_fn, gamma, double_q, num_atoms, v_min, v_max, p, tp,
             mb, w):
    """Projected-Bellman categorical cross-entropy (C51, Bellemare et al.
    2017); aux the per-sample cross-entropies."""
    K = num_atoms
    z = c51_support(v_min, v_max, K, mb["obs"].device)
    dz = (v_max - v_min) / (K - 1)
    logits = dist_fn(p, mb["obs"])                          # [B, A, K]
    act = mb["action"].long()[:, None, None].expand(-1, 1, K)
    logp = torch.log_softmax(torch.gather(logits, 1, act)[:, 0], -1)
    with torch.no_grad():
        a_star = torch.argmax(q_fn(p if double_q else tp, mb["next_obs"]),
                              dim=1)
        next_logits = torch.gather(
            dist_fn(tp, mb["next_obs"]), 1,
            a_star[:, None, None].expand(-1, 1, K))[:, 0]   # [B, K]
        p_next = torch.softmax(next_logits, -1)
        tz = torch.clamp(
            mb["reward"][:, None]
            + gamma * (1.0 - mb["done"])[:, None] * z[None, :],
            v_min, v_max)                                   # [B, K]
        b = (tz - v_min) / dz
        low = torch.clamp(torch.floor(b), 0, K - 1)
        up = torch.clamp(low + 1, 0, K - 1)
        wu = b - low
        wl = 1.0 - wu                                       # low==up → wl
        atoms = torch.arange(K, device=b.device)
        m = (torch.einsum("bk,bkj->bj", p_next * wl,
                          (low.long()[..., None] == atoms).float())
             + torch.einsum("bk,bkj->bj", p_next * wu,
                            (up.long()[..., None] == atoms).float()))
    ce = -torch.sum(m * logp, dim=-1)                       # [B]
    return torch.mean(w * ce), ce


class _Steps(Steps):
    """One iteration's env steps over tensors updated in place.  ``act``
    (an epsilon-greedy action, then the env step) and ``learn`` (a
    sample, the loss, the Adam update) read their step's draws, epsilon
    and bias corrections through device counters, so each does the same
    work whenever it runs: on the card each is captured once as a CUDA
    graph and replayed (``graphs``), on the CPU (and for the prioritized
    buffer, whose sampling sorts on the host's fill count) it runs
    eagerly.  The host keeps the step and fill counts that decide when to
    learn and to sync the target."""

    def __init__(self, env, buffer, tx, loss_fn, q_fn, cfg, params,
                 target_params, opt_state, buf_state, env_state, obs,
                 ep_ret, draws):
        super().__init__(env, buffer, buf_state, env_state, obs, ep_ret,
                         draws)
        dev = obs.device
        self.tx, self.loss_fn, self.q_fn, self.cfg = tx, loss_fn, q_fn, cfg
        self.params, self.target_params = params, target_params
        self.opt_state = opt_state
        self.prioritized = isinstance(buffer, PrioritizedDeviceReplayBuffer)
        T = cfg.steps_per_iteration
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.eps = torch.zeros((T,), device=dev)
        self.bias = torch.zeros((T, 2), device=dev)
        self.loss_sum = torch.zeros((), device=dev)
        self.w = torch.ones((cfg.train_batch_size,), device=dev)

    def begin(self, draws, total_steps: int) -> None:
        """Load an iteration: its draws, each step's epsilon and each
        update's bias corrections (from the host's counts), the counters
        and the sums."""
        cfg, n = self.cfg, self.obs.shape[0]
        base = self.buf_state.base if self.prioritized else self.buf_state
        super().begin(draws, base.ptr, base.size)
        T = cfg.steps_per_iteration
        self.eps.copy_(torch.tensor(
            [epsilon(cfg, total_steps + t * n) for t in range(T)]))
        self.bias.copy_(bias_table(self.tx, self.opt_state["count"], T,
                                   self.bias.device))
        self.k.zero_()
        self.loss_sum.zero_()

    def store(self, batch) -> None:
        if self.prioritized:
            self.buf_state = self.buffer.add_batch(self.buf_state, batch)
        else:
            super().store(batch)

    def act(self) -> None:
        with torch.no_grad():
            greedy = torch.argmax(self.q_fn(self.params, self.obs),
                                  dim=1).to(torch.int32)
        self.step_env(torch.where(
            self.row("eps") < self.eps.index_select(0, self.t),
            self.row("random_action"), greedy))

    def learn(self, noise=None) -> None:
        """One update on the sample of the step just taken (``noise``: the
        prioritized buffer's Gumbel draws)."""
        cfg = self.cfg
        if self.prioritized:
            mb, idx, w = self.buffer.sample(self.buf_state, noise,
                                            cfg.train_batch_size)
        else:
            mb, w = self.sample(), self.w
        # Fresh leaves over the params' storage: their autograd nodes
        # belong to the stream this runs on, which a capture needs (the
        # params' own leaves were made on the default stream).
        (loss, err), grads = value_and_grad(
            self.loss_fn, trainable(self.params), self.target_params, mb, w)
        bias = self.bias.index_select(0, self.k)[0]
        self.tx.update_(self.params, grads, self.opt_state,
                        bias=(bias[0], bias[1]))
        if self.prioritized:
            self.buf_state = self.buffer.update_priorities(
                self.buf_state, idx, err.detach())
        self.k.add_(1)
        self.loss_sum.add_(loss.detach())


def _dqn_iteration(env, buffer, tx, q_fn, dist_fn, cfg, params,
                   target_params, opt_state, buf_state, env_state, obs,
                   ep_ret, total_steps: int, draws, dev_gen, graphs=None):
    """``cfg.steps_per_iteration`` env steps on ``draws`` (a prioritized
    buffer's Gumbel noise from ``draws["noise"]`` [T, capacity] if given,
    else from ``dev_gen``); params, target params, moments, the buffer
    and the env state are updated in place.  With ``graphs`` (a dict kept
    across iterations, on the card, for the uniform buffer) the steps run
    as CUDA graphs.  Returns (buf_state, env_state, obs, ep_ret,
    total_steps, opt_state, metrics)."""
    T, n = cfg.steps_per_iteration, obs.shape[0]
    prioritized = isinstance(buffer, PrioritizedDeviceReplayBuffer)
    if prioritized:
        graphs = None
    if cfg.num_atoms > 1:
        loss_fn = lambda p, tp, mb, w: c51_loss(  # noqa: E731
            q_fn, dist_fn, cfg.gamma, cfg.double_q, cfg.num_atoms,
            cfg.v_min, cfg.v_max, p, tp, mb, w)
    else:
        loss_fn = lambda p, tp, mb, w: td_loss(  # noqa: E731
            q_fn, cfg.gamma, cfg.double_q, p, tp, mb, w)
    step_draws = {k: v for k, v in draws.items() if k != "noise"}
    steps = graphs.get("steps") if graphs is not None else None
    if steps is None:
        steps = _Steps(env, buffer, tx, loss_fn, q_fn, cfg, params,
                       target_params, opt_state, buf_state, env_state, obs,
                       ep_ret, step_draws)
        if graphs is not None:
            graphs["steps"] = steps
    steps.opt_state, steps.buf_state = opt_state, buf_state
    steps.begin(step_draws, total_steps)
    train_every = max(cfg.train_freq // n, 1)
    sync_every = max(cfg.target_update_freq // n, 1)
    base = buf_state.base if prioritized else buf_state
    ptr, filled, updates = base.ptr, base.size, 0
    for t in range(T):
        _run(graphs, "act", steps.act)
        total_steps += n
        ptr, filled = (ptr + n) % buffer.capacity, min(filled + n,
                                                       buffer.capacity)
        if (filled >= cfg.learning_starts
                and (total_steps // n) % train_every == 0):
            noise = None
            if prioritized:
                noise = (draws["noise"][t] if "noise" in draws
                         else buffer.draw(dev_gen))
            _run(graphs, "learn", lambda: steps.learn(noise))
            updates += 1
        if (total_steps // n) % sync_every == 0:
            torch._foreach_copy_(tree_leaves(target_params),
                                 tree_leaves(params))
    opt_state = dict(opt_state, count=opt_state["count"] + updates)
    if prioritized:
        buf_state = steps.buf_state
    else:
        buf_state = BufferState(buf_state.data, ptr, filled)
    ret_sum, ret_cnt, loss_mean = torch.stack(
        [steps.ret_sum, steps.ret_cnt.float(), steps.loss_sum / T]).tolist()
    metrics = {
        "episode_return_mean": (ret_sum / ret_cnt if ret_cnt > 0
                                else float("nan")),
        "loss_mean": loss_mean,
        "buffer_size": float(filled),
        "epsilon": epsilon(cfg, total_steps),
    }
    return (buf_state, env_state, obs, ep_ret, total_steps, opt_state,
            metrics)
