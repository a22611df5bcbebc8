"""What the off-policy algorithms share: env steps into a device replay
buffer and updates over tensors changed in place, run eagerly or as CUDA
graphs.

A ``Steps`` object holds one iteration's draws and the counters that
index them (the step ``t``, the buffer's write slot and fill count) as
device tensors, so ``step_env`` and a subclass's ``learn`` do the same
work whenever they run: on the card each is captured once as a CUDA graph
and replayed (:func:`run_graph`), on the CPU it runs eagerly.  The host
keeps its own step and fill counts, which decide when to learn.
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.rllib.env import terminal_mask
from ray_tpu_torch.train.state import AdamW, tree_leaves


def run_graph(graphs, name: str, fn) -> None:
    """``fn`` eagerly (``graphs`` None), or as ``graphs[name]``: two
    eager runs on a side stream to warm up, then captured once and
    replayed from then on."""
    if graphs is None:
        fn()
        return
    g = graphs.get(name)
    if g is None:
        warm = graphs.get(name + ".warm", 0)
        if warm < 2:
            side = graphs.setdefault("stream", torch.cuda.Stream())
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graphs[name + ".warm"] = warm + 1
            return
        g = graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
    g.replay()


def bias_table(tx: AdamW, count: int, n: int, device) -> torch.Tensor:
    """Adam's two bias corrections of the next ``n`` updates after
    ``count``, as an [n, 2] tensor an update indexes by its counter."""
    return torch.tensor([tx.bias_corrections(count + 1 + k)
                         for k in range(n)], device=device)


@torch.no_grad()
def polyak_(target, online, tau: float) -> None:
    """``target = (1 - tau) * target + tau * online`` over matching trees,
    in place, in the JAX package's order."""
    ts = tree_leaves(target)
    torch._foreach_mul_(ts, 1 - tau)
    torch._foreach_add_(ts, torch._foreach_mul(tree_leaves(online), tau))


def detach(tree):
    """A param tree with every leaf detached (``lax.stop_gradient``)."""
    if isinstance(tree, dict):
        return {k: detach(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [detach(v) for v in tree]
    return tree.detach()


class Steps:
    """One iteration's env steps into a uniform device replay buffer.
    ``draws`` holds [T, ...] rows: ``reset`` and ``sample`` at least; the
    subclass reads its own through :meth:`row`."""

    def __init__(self, env, buffer, buf_state, env_state, obs, ep_ret,
                 draws: Dict[str, torch.Tensor]):
        dev = obs.device
        self.env, self.buffer, self.buf_state = env, buffer, buf_state
        self.env_state, self.obs, self.ep_ret = env_state, obs, ep_ret
        i64 = dict(dtype=torch.int64, device=dev)
        self.t = torch.zeros((), **i64)          # step, into the draws
        self.slot = torch.zeros((), **i64)       # the buffer's next slot
        self.size = torch.zeros((), **i64)       # its fill count
        self.lanes = torch.arange(obs.shape[0], **i64)
        self.draws = {k: v.clone() for k, v in draws.items()}
        self.ret_sum = torch.zeros((), device=dev)
        self.ret_cnt = torch.zeros((), **i64)

    def begin(self, draws: Dict[str, torch.Tensor], ptr: int,
              size: int) -> None:
        """Load an iteration's draws and the buffer's host counts; zero
        the step counter and the return sums."""
        for k, v in draws.items():
            self.draws[k].copy_(v)
        self.slot.fill_(ptr)
        self.size.fill_(size)
        for x in (self.t, self.ret_sum, self.ret_cnt):
            x.zero_()

    def row(self, name: str, back: int = 0) -> torch.Tensor:
        """Draw ``name`` of step ``t - back``."""
        at = self.t - back if back else self.t
        return self.draws[name].index_select(0, at)[0]

    def step_env(self, action: torch.Tensor) -> None:
        """The env step on ``action``, the buffer write, the episode
        returns and the auto-reset; then ``t`` moves on."""
        env, n = self.env, self.obs.shape[0]
        next_state, next_obs, reward, done = env.step(self.env_state, action)
        self.store({"obs": self.obs, "action": action, "reward": reward,
                    "next_obs": next_obs,
                    # Bootstrap through time-limit truncations; only true
                    # terminals zero the target.
                    "done": terminal_mask(env, next_state, done)})
        ep = self.ep_ret + reward
        self.ret_sum.add_(torch.sum(torch.where(done, ep, 0.0)))
        self.ret_cnt.add_(torch.sum(done))
        self.ep_ret.copy_(torch.where(done, 0.0, ep))
        r_state, r_obs = env.reset(self.row("reset"))
        for k, v in self.env_state.items():
            v.copy_(torch.where(done.reshape((n,) + (1,) * (v.dim() - 1)),
                                r_state[k], next_state[k]))
        self.obs.copy_(torch.where(done[:, None], r_obs, next_obs))
        self.t.add_(1)

    def store(self, batch: Dict[str, torch.Tensor]) -> None:
        """The ring write of one step's [n, ...] transitions at the device
        slot counter."""
        cap, n = self.buffer.capacity, self.obs.shape[0]
        slots = (self.slot + self.lanes) % cap
        for k, buf in self.buf_state.data.items():
            buf.index_copy_(0, slots, batch[k])
        self.slot.copy_((self.slot + n) % cap)
        self.size.copy_(torch.clamp_max(self.size + n, cap))

    def sample(self) -> Dict[str, torch.Tensor]:
        """The uniform sample of the step just taken: slot ``floor(u *
        size)`` for each of its draws ``u``."""
        u = self.row("sample", back=1)
        idx = torch.minimum((u * self.size.float()).long(), self.size - 1)
        return {k: v.index_select(0, idx)
                for k, v in self.buf_state.data.items()}

    def episode_return(self) -> float:
        """The mean return of the episodes that ended (NaN if none)."""
        s, c = torch.stack([self.ret_sum, self.ret_cnt.float()]).tolist()
        return s / c if c > 0 else float("nan")
