"""Policy and value networks (port of ``ray_tpu/rllib/models.py``).

Networks are (init, apply) function pairs over the JAX package's param
trees — ``{"layers": [{"w": [in, out], "b": [out]}, ...]}`` for an MLP —
so ``bridge.params_from_jax`` carries a JAX net across as a copy.  Init
draws from a ``torch.Generator`` (orthogonal, as in the JAX package; the
draws differ).  Distributions take their noise as an argument
(``sample(noise)``; ``ActorCritic.draw`` makes it): Categorical samples
``argmax(logits + gumbel)``, which is what ``jax.random.categorical``
computes, and DiagGaussian ``mean + std * normal``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import numpy as np
import torch

Params = Dict[str, Any]


def _dense_init(generator, in_dim: int, out_dim: int, scale: float,
                device) -> Params:
    # Orthogonal init (standard for PPO-family stability).
    w = torch.empty((in_dim, out_dim), dtype=torch.float32)
    torch.nn.init.orthogonal_(w, gain=scale, generator=generator)
    return {"w": w.to(device), "b": torch.zeros((out_dim,), device=device)}


def _dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def init_mlp(generator: torch.Generator, in_dim: int, hidden: Sequence[int],
             out_dim: int, final_scale: float = 0.01,
             device="cpu") -> Params:
    """Draws on ``generator`` (a CPU one), tensors on ``device``."""
    dims = [in_dim, *hidden]
    layers = [_dense_init(generator, dims[i], dims[i + 1], math.sqrt(2.0),
                          device)
              for i in range(len(dims) - 1)]
    layers.append(_dense_init(generator, dims[-1], out_dim, final_scale,
                              device))
    return {"layers": layers}


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    for layer in p["layers"][:-1]:
        x = torch.tanh(_dense(layer, x))
    return _dense(p["layers"][-1], x)


class Categorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """``noise``: standard Gumbel draws of the logits' shape."""
        return torch.argmax(self.logits + noise, dim=-1)

    def log_prob(self, action: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return torch.gather(logp, -1, action[..., None].long())[..., 0]

    def entropy(self) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)


class DiagGaussian:
    def __init__(self, mean: torch.Tensor, log_std: torch.Tensor):
        self.mean, self.log_std = mean, log_std

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """``noise``: standard normal draws of the mean's shape."""
        return self.mean + torch.exp(self.log_std) * noise

    def log_prob(self, action: torch.Tensor) -> torch.Tensor:
        var = torch.exp(2 * self.log_std)
        ll = -0.5 * ((action - self.mean) ** 2 / var
                     + 2 * self.log_std + math.log(2 * math.pi))
        return torch.sum(ll, dim=-1)

    def entropy(self) -> torch.Tensor:
        return torch.sum(self.log_std
                         + 0.5 * math.log(2 * math.pi * math.e), dim=-1)

    def mode(self) -> torch.Tensor:
        return self.mean


def gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(E)`` with E ~ Exp(1)."""
    e = torch.empty(tuple(shape), device=generator.device)
    return -torch.log(e.exponential_(generator=generator))


class ActorCritic:
    """Separate policy and value MLPs; categorical or diagonal-gaussian
    action head chosen by ``discrete``."""

    def __init__(self, obs_dim: int, act_dim: int, *, discrete: bool,
                 hidden: Sequence[int] = (64, 64)):
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.discrete = discrete
        self.hidden = tuple(hidden)

    def init(self, generator: torch.Generator, device="cpu") -> Params:
        params = {
            "pi": init_mlp(generator, self.obs_dim, self.hidden,
                           self.act_dim, device=device),
            "vf": init_mlp(generator, self.obs_dim, self.hidden, 1,
                           final_scale=1.0, device=device),
        }
        if not self.discrete:
            params["log_std"] = torch.zeros((self.act_dim,), device=device)
        return params

    def value(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        return apply_mlp(params["vf"], obs).squeeze(-1)

    def action_dist(self, params: Params, obs: torch.Tensor):
        out = apply_mlp(params["pi"], obs)
        if self.discrete:
            return Categorical(out)
        return DiagGaussian(out, params["log_std"])

    def draw(self, generator: torch.Generator, shape) -> torch.Tensor:
        """The noise ``sample_action`` takes: ``shape`` ends in
        ``act_dim`` (Gumbel for a discrete head, normal otherwise)."""
        if self.discrete:
            return gumbel(generator, shape)
        return torch.randn(tuple(shape), generator=generator,
                           device=generator.device)

    def sample_action(self, params: Params, obs: torch.Tensor,
                      noise: torch.Tensor):
        dist = self.action_dist(params, obs)
        action = dist.sample(noise)
        return action, dist.log_prob(action)


def init_q_net(generator: torch.Generator, obs_dim: int, act_dim: int,
               hidden: Sequence[int] = (64, 64), device="cpu") -> Params:
    return init_mlp(generator, obs_dim, hidden, act_dim, final_scale=1.0,
                    device=device)


def q_values(params: Params, obs: torch.Tensor) -> torch.Tensor:
    return apply_mlp(params, obs)


def init_dueling_q_net(generator: torch.Generator, obs_dim: int,
                       act_dim: int, hidden: Sequence[int] = (64, 64),
                       device="cpu") -> Params:
    """Dueling head: a shared torso with separate value and advantage
    streams, combined as Q = V + A - mean(A)."""
    torso_out = hidden[-1]
    return {
        "torso": init_mlp(generator, obs_dim, tuple(hidden[:-1]), torso_out,
                          final_scale=1.0, device=device),
        "adv": init_mlp(generator, torso_out, (), act_dim, final_scale=1.0,
                        device=device),
        "val": init_mlp(generator, torso_out, (), 1, final_scale=1.0,
                        device=device),
    }


def dueling_q_values(params: Params, obs: torch.Tensor) -> torch.Tensor:
    h = torch.relu(apply_mlp(params["torso"], obs))
    adv = apply_mlp(params["adv"], h)
    val = apply_mlp(params["val"], h)
    return val + adv - torch.mean(adv, dim=-1, keepdim=True)


def c51_support(v_min: float, v_max: float, num_atoms: int,
                device=None) -> torch.Tensor:
    """``jnp.linspace(v_min, v_max, num_atoms)``'s formula (``start * (1 -
    s) + stop * s``, s = i / (K - 1), the end exact); XLA's rounding of
    it may differ by an ulp."""
    k = num_atoms - 1
    lo, hi = float(np.float32(v_min)), float(np.float32(v_max))
    s = torch.arange(k, dtype=torch.float32, device=device) / float(k)
    out = torch.full((num_atoms,), hi, dtype=torch.float32, device=device)
    out[:k] = (1 - s) * lo + s * hi
    return out
