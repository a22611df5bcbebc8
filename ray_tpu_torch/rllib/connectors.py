"""Connector pipelines: composable observation/action transforms (port
of ``ray_tpu/rllib/connectors.py``).

Connectors are pure functions over (data, state), so a pipeline can run
inside a batched rollout; stateful ones (running mean/std) thread their
state explicitly, as tensors on the data's device.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


class Connector:
    """One transform.  init_state(device) → state; __call__(x, state) →
    (x', state')."""

    def init_state(self, device: DeviceLike = None) -> Any:
        return ()

    def __call__(self, x: torch.Tensor, state: Any
                 ) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError


class FlattenObservations(Connector):
    def __call__(self, x, state):
        return x.reshape((x.shape[0], -1)) if x.dim() > 2 else x, state


class ClipActions(Connector):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, x, state):
        return torch.clamp(x, self.low, self.high), state


class MeanStdState(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor


class MeanStdFilter(Connector):
    """Running observation normalization — a Welford update."""

    def __init__(self, shape: Sequence[int], clip: float = 10.0):
        self.shape = tuple(shape)
        self.clip = clip

    def init_state(self, device: DeviceLike = None) -> MeanStdState:
        dev = resolve_device(device)
        return MeanStdState(torch.zeros(self.shape, device=dev),
                            torch.ones(self.shape, device=dev),
                            torch.ones((), device=dev))

    def __call__(self, x, state: MeanStdState):
        bmean = torch.mean(x, dim=0)
        bvar = torch.var(x, dim=0, correction=0)
        bn = float(x.shape[0])
        delta = bmean - state.mean
        tot = state.count + bn
        mean = state.mean + delta * bn / tot
        m_a = state.var * state.count
        m_b = bvar * bn
        var = (m_a + m_b + delta ** 2 * state.count * bn / tot) / tot
        out = torch.clamp((x - mean) / torch.sqrt(var + 1e-8),
                          -self.clip, self.clip)
        return out, MeanStdState(mean, var, tot)


class FrameStack(Connector):
    """Stack the last k observations along the feature axis."""

    def __init__(self, k: int, obs_shape: Sequence[int]):
        self.k = k
        self.obs_shape = tuple(obs_shape)

    def init_state(self, device: DeviceLike = None):
        return torch.zeros((self.k,) + self.obs_shape,
                           device=resolve_device(device))

    def __call__(self, x, state):
        # x [B, ...] with B == 1 conceptually per env.
        state = torch.cat([state[1:], x[None, 0]], dim=0)
        out = state.reshape((1, -1))
        return out.expand(x.shape[0], out.shape[-1]), state


class ConnectorPipeline:
    """Ordered connectors with one combined state tuple."""

    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def init_state(self, device: DeviceLike = None) -> Tuple[Any, ...]:
        return tuple(c.init_state(device) for c in self.connectors)

    def __call__(self, x, state: Tuple[Any, ...]):
        out_states = []
        for c, s in zip(self.connectors, state):
            x, s2 = c(x, s)
            out_states.append(s2)
        return x, tuple(out_states)
