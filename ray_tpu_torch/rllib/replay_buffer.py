"""Replay buffers (port of ``ray_tpu/rllib/replay_buffer.py``).

:class:`DeviceReplayBuffer` keeps the whole buffer as fixed-shape
tensors on the device, so an insert is a slice copy and a uniform
sample a gather — no host round trip per transition.  Its write pointer
and fill count are host integers (every insert's size is known on the
host), so deciding whether to train never reads the device.  Sampling
takes its draws as an argument (drawn first, in bulk: ``draw``).
:class:`PrioritizedDeviceReplayBuffer` samples by a Gumbel top-k over
log-priorities (sampling without replacement proportional to p^alpha)
from Gumbel noise drawn first and passed in.  :class:`HostReplayBuffer`
and :class:`EpisodeReplayBuffer` are the numpy ones of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rllib.models import gumbel


class BufferState(NamedTuple):
    data: Dict[str, torch.Tensor]  # each [capacity, ...]
    ptr: int                       # next write slot
    size: int                      # number of valid entries


class DeviceReplayBuffer:
    """Uniform ring buffer in device memory."""

    def __init__(self, capacity: int,
                 specs: Dict[str, Tuple[tuple, torch.dtype]],
                 device: DeviceLike = None):
        """specs: name -> (shape, dtype) of ONE transition."""
        self.capacity = capacity
        self.specs = specs
        self.device = resolve_device(device)

    def init(self) -> BufferState:
        data = {k: torch.zeros((self.capacity,) + tuple(shape), dtype=dtype,
                               device=self.device)
                for k, (shape, dtype) in self.specs.items()}
        return BufferState(data, 0, 0)

    def _slots(self, ptr: int, n: int):
        """The ring slots of ``n`` rows written at ``ptr``: one slice, or
        two where the write wraps."""
        end = ptr + n
        if end <= self.capacity:
            return [(slice(ptr, end), slice(0, n))]
        first = self.capacity - ptr
        return [(slice(ptr, self.capacity), slice(0, first)),
                (slice(0, n - first), slice(first, n))]

    def add_batch(self, state: BufferState,
                  batch: Dict[str, torch.Tensor]) -> BufferState:
        """Insert a [B, ...] batch in place, wrapping around the ring (B
        at most the capacity)."""
        n = next(iter(batch.values())).shape[0]
        for dst, src in self._slots(state.ptr, n):
            for k, buf in state.data.items():
                buf[dst] = batch[k][src]
        return BufferState(state.data, (state.ptr + n) % self.capacity,
                           min(state.size + n, self.capacity))

    def draw(self, generator: torch.Generator, batch_size: int,
             leading=()) -> torch.Tensor:
        """Uniform [0, 1) draws for ``sample`` (``leading`` dims first, so
        a whole iteration's draws come in one go)."""
        return torch.rand(tuple(leading) + (batch_size,),
                          generator=generator, device=generator.device)

    def sample(self, state: BufferState, u: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """A uniform sample over the filled slots: slot ``floor(u *
        size)`` for each draw ``u``."""
        n = max(state.size, 1)
        idx = torch.clamp_max((u * n).long(), n - 1)
        return {k: v[idx] for k, v in state.data.items()}


class PrioritizedState(NamedTuple):
    base: BufferState
    priority: torch.Tensor  # [capacity] float32 (0 = empty slot)


class PrioritizedDeviceReplayBuffer:
    """Proportional prioritized replay on the device: a Gumbel top-k over
    log-priorities, equivalent to sampling without replacement
    proportional to p^alpha."""

    def __init__(self, capacity: int,
                 specs: Dict[str, Tuple[tuple, torch.dtype]],
                 *, alpha: float = 0.6, beta: float = 0.4,
                 eps: float = 1e-6, device: DeviceLike = None):
        self._ring = DeviceReplayBuffer(capacity, specs, device)
        self.capacity = capacity
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.device = self._ring.device

    def init(self) -> PrioritizedState:
        return PrioritizedState(
            self._ring.init(),
            torch.zeros((self.capacity,), dtype=torch.float32,
                        device=self.device))

    def add_batch(self, state: PrioritizedState,
                  batch: Dict[str, torch.Tensor]) -> PrioritizedState:
        """New transitions enter at MAX current priority (the standard
        bias toward replaying the newest data at least once)."""
        n = next(iter(batch.values())).shape[0]
        pmax = torch.clamp_min(torch.max(state.priority), 1.0)
        for dst, _ in self._ring._slots(state.base.ptr, n):
            state.priority[dst] = pmax
        return PrioritizedState(self._ring.add_batch(state.base, batch),
                                state.priority)

    def draw(self, generator: torch.Generator, leading=()) -> torch.Tensor:
        """Standard Gumbel noise over the slots."""
        return gumbel(generator, tuple(leading) + (self.capacity,))

    def sample(self, state: PrioritizedState, noise: torch.Tensor,
               batch_size: int):
        """(batch, idx, importance_weights) from Gumbel ``noise``
        [capacity]; weights normalized to max 1 (the (N·P)^-beta
        correction)."""
        logits = self.alpha * torch.log(state.priority + self.eps)
        logits = torch.where(state.priority > 0, logits, -torch.inf)
        # lax.top_k: the larger first, ties to the lower index.
        idx = torch.sort(logits + noise, descending=True, stable=True
                         ).indices[:batch_size]
        # batch_size > filled slots: top-k spills into empty (-inf)
        # slots — remap those onto real entries (duplicates, as sampling
        # with replacement from a small buffer would give).
        valid = state.priority[idx] > 0
        idx = torch.where(valid, idx, idx % max(state.base.size, 1))
        probs = state.priority[idx] ** self.alpha
        probs = probs / torch.clamp_min(
            torch.sum(state.priority ** self.alpha), self.eps)
        n = float(max(state.base.size, 1))
        w = (n * torch.clamp_min(probs, self.eps)) ** (-self.beta)
        w = w / torch.clamp_min(torch.max(w), self.eps)
        batch = {k: v[idx] for k, v in state.base.data.items()}
        return batch, idx, w

    def update_priorities(self, state: PrioritizedState, idx: torch.Tensor,
                          td_error: torch.Tensor) -> PrioritizedState:
        state.priority[idx] = torch.abs(td_error.detach()) + self.eps
        return state


class EpisodeReplayBuffer:
    """Host-side episode buffer sampling fixed-length SEGMENTS (the
    buffer recurrent/sequence learners sample from)."""

    def __init__(self, capacity_episodes: int):
        self.capacity = capacity_episodes
        self._episodes: list = []
        self._ptr = 0

    def __len__(self) -> int:
        return len(self._episodes)

    def add_episode(self, episode: Dict[str, np.ndarray]) -> None:
        """episode: name → [T, ...] arrays, equal T."""
        if len(self._episodes) < self.capacity:
            self._episodes.append(episode)
        else:
            self._episodes[self._ptr] = episode
        self._ptr = (self._ptr + 1) % self.capacity

    def sample_segments(self, batch_size: int, seg_len: int,
                        rng: Optional[np.random.Generator] = None
                        ) -> Dict[str, np.ndarray]:
        """[B, seg_len, ...] stacked segments; short episodes pad with
        their last step and carry a 'mask'."""
        rng = rng or np.random.default_rng()
        out: Dict[str, list] = {}
        masks = []
        for _ in range(batch_size):
            ep = self._episodes[rng.integers(0, len(self._episodes))]
            T = len(next(iter(ep.values())))
            start = int(rng.integers(0, max(1, T - seg_len + 1)))
            end = min(start + seg_len, T)
            mask = np.zeros((seg_len,), np.float32)
            mask[: end - start] = 1.0
            masks.append(mask)
            for k, v in ep.items():
                seg = v[start:end]
                if len(seg) < seg_len:
                    pad = np.repeat(seg[-1:], seg_len - len(seg), axis=0)
                    seg = np.concatenate([seg, pad], axis=0)
                out.setdefault(k, []).append(seg)
        stacked = {k: np.stack(v) for k, v in out.items()}
        stacked["mask"] = np.stack(masks)
        return stacked


class HostReplayBuffer:
    """Numpy ring buffer (parity: the reference's ReplayBuffer)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._storage: list = []
        self._ptr = 0

    def __len__(self) -> int:
        return len(self._storage)

    def add(self, item: Any) -> None:
        if len(self._storage) < self.capacity:
            self._storage.append(item)
        else:
            self._storage[self._ptr] = item
        self._ptr = (self._ptr + 1) % self.capacity

    def sample(self, batch_size: int,
               rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        idx = rng.integers(0, len(self._storage), batch_size)
        return [self._storage[i] for i in idx]
