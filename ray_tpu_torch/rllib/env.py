"""Batched environments on the device (port of ``ray_tpu/rllib/env.py``).

The JAX package writes an environment as a pure function of one env's
(state, action) and vmaps it; here ``reset`` and ``step`` take the whole
batch at once — state is a dict of [N, ...] tensors on one device — so a
rollout of N envs is a handful of elementwise kernels a step.
Randomness is drawn first and passed in: ``reset(draws)`` takes the
uniform [0, 1) draws ``draw_reset`` makes (shape ``[N, *reset_draws]``)
and turns them into states with the JAX package's arithmetic, so a test
can hand in the draws JAX made and get its states.

Env protocol:

    env.draw_reset(generator, n)   -> draws (on the generator's device)
    env.reset(draws)               -> (state, obs)
    env.step(state, action)        -> (state, obs, reward, done)
    env.observation_size / env.action_size / env.discrete
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

State = Dict[str, torch.Tensor]


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(key, minval=lo, maxval=hi)`` from its [0, 1)
    floats ``u``: ``max(lo, u * (hi - lo) + lo)`` in float32 (the bounds
    and their difference rounded to float32 first, as JAX takes them;
    Python scalars, so no tensor is made on the device)."""
    lo32 = float(np.float32(lo))
    span = float(np.float32(np.float32(hi) - np.float32(lo)))
    return torch.clamp_min(u * span + lo32, lo32)


class _DrawMixin:
    reset_draws: Tuple[int, ...] = ()

    def draw_reset(self, generator: torch.Generator, n: int,
                   leading: Tuple[int, ...] = ()) -> torch.Tensor:
        """Uniform [0, 1) draws for ``n`` resets (``leading`` dims first,
        e.g. one set per rollout step)."""
        return torch.rand(tuple(leading) + (n,) + tuple(self.reset_draws),
                          generator=generator, device=generator.device)


@dataclasses.dataclass(frozen=True)
class CartPole(_DrawMixin):
    """Classic cart-pole balancing (standard dynamics; episode caps at
    ``max_steps``).  Discrete 2-action, 4-dim observation."""

    gravity: float = 9.8
    cart_mass: float = 1.0
    pole_mass: float = 0.1
    pole_len: float = 0.5  # half-length
    force_mag: float = 10.0
    dt: float = 0.02
    theta_limit: float = 12 * 2 * math.pi / 360
    x_limit: float = 2.4
    max_steps: int = 500

    observation_size: int = 4
    action_size: int = 2
    discrete: bool = True
    reset_draws: Tuple[int, ...] = (4,)

    def reset(self, draws: torch.Tensor) -> Tuple[State, torch.Tensor]:
        obs = _uniform(draws, -0.05, 0.05)
        state = {"obs": obs,
                 "t": torch.zeros(draws.shape[:-1], dtype=torch.int32,
                                  device=draws.device)}
        return state, obs

    def step(self, state: State, action: torch.Tensor):
        x, x_dot, theta, theta_dot = state["obs"].unbind(-1)
        force = torch.where(action == 1, self.force_mag, -self.force_mag
                            ).to(torch.float32)
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        total_mass = self.cart_mass + self.pole_mass
        pm_len = self.pole_mass * self.pole_len
        temp = (force + pm_len * theta_dot ** 2 * sin_t) / total_mass
        theta_acc = (self.gravity * sin_t - cos_t * temp) / (
            self.pole_len * (4.0 / 3.0 - self.pole_mass * cos_t ** 2
                             / total_mass))
        x_acc = temp - pm_len * theta_acc * cos_t / total_mass
        x = x + self.dt * x_dot
        x_dot = x_dot + self.dt * x_acc
        theta = theta + self.dt * theta_dot
        theta_dot = theta_dot + self.dt * theta_acc
        obs = torch.stack([x, x_dot, theta, theta_dot], -1)
        t = state["t"] + 1
        done = ((x.abs() > self.x_limit) | (theta.abs() > self.theta_limit)
                | (t >= self.max_steps))
        return {"obs": obs, "t": t}, obs, torch.ones_like(x), done


@dataclasses.dataclass(frozen=True)
class Pendulum(_DrawMixin):
    """Torque-controlled pendulum swing-up; continuous 1-dim action in
    [-max_torque, max_torque], 3-dim observation (cos, sin, theta_dot)."""

    max_speed: float = 8.0
    max_torque: float = 2.0
    dt: float = 0.05
    gravity: float = 10.0
    mass: float = 1.0
    length: float = 1.0
    max_steps: int = 200

    observation_size: int = 3
    action_size: int = 1
    discrete: bool = False
    reset_draws: Tuple[int, ...] = (2,)

    def _obs(self, theta, theta_dot):
        return torch.stack([torch.cos(theta), torch.sin(theta), theta_dot],
                           -1)

    def reset(self, draws: torch.Tensor):
        theta = _uniform(draws[..., 0], -math.pi, math.pi)
        theta_dot = _uniform(draws[..., 1], -1.0, 1.0)
        state = {"theta": theta, "theta_dot": theta_dot,
                 "t": torch.zeros(theta.shape, dtype=torch.int32,
                                  device=draws.device)}
        return state, self._obs(theta, theta_dot)

    def step(self, state: State, action: torch.Tensor):
        u = torch.clamp(action.reshape(action.shape[0]), -self.max_torque,
                        self.max_torque)
        theta, theta_dot = state["theta"], state["theta_dot"]
        norm_theta = torch.remainder(theta + math.pi, 2 * math.pi) - math.pi
        cost = norm_theta ** 2 + 0.1 * theta_dot ** 2 + 0.001 * u ** 2
        g, m, l, dt = self.gravity, self.mass, self.length, self.dt
        theta_dot = theta_dot + (
            3 * g / (2 * l) * torch.sin(theta) + 3.0 / (m * l ** 2) * u
        ) * dt
        theta_dot = torch.clamp(theta_dot, -self.max_speed, self.max_speed)
        theta = theta + theta_dot * dt
        t = state["t"] + 1
        done = t >= self.max_steps
        new_state = {"theta": theta, "theta_dot": theta_dot, "t": t}
        return new_state, self._obs(theta, theta_dot), -cost, done


def terminal_mask(env, next_state, done):
    """``done`` minus time-limit truncation, as float32.

    1.0 only where the episode TRULY terminated: hitting a ``max_steps``
    cap is a time limit, where TD targets and GAE must bootstrap the
    next state's value.  An episode that truly terminates exactly at the
    cap counts as truncated, as in the JAX package."""
    max_steps = getattr(env, "max_steps", None)
    if max_steps is None:
        return done.to(torch.float32)
    try:
        t = next_state["t"]
    except (KeyError, TypeError):
        return done.to(torch.float32)
    trunc = (t >= max_steps).to(torch.float32)
    # Arithmetic form: custom envs may return done as float.
    return done.to(torch.float32) * (1.0 - trunc)


class ExternalEnv:
    """Adapter for Python (gym/gymnasium-style) envs, stepped one env at
    a time on the host."""

    def __init__(self, make_env):
        self._make_env = make_env
        self._env = make_env()
        space = self._env.action_space
        self.discrete = hasattr(space, "n")
        self.action_size = space.n if self.discrete else space.shape[0]
        self.observation_size = self._env.observation_space.shape[0]

    def reset(self, seed=None):
        try:
            out = self._env.reset(seed=seed)
        except TypeError:  # pre-gymnasium envs take no seed kwarg
            if seed is not None and hasattr(self._env, "seed"):
                self._env.seed(seed)
            out = self._env.reset()
        return out[0] if isinstance(out, tuple) else out

    def step(self, action):
        out = self._env.step(action)
        if len(out) == 5:  # gymnasium: obs, r, terminated, truncated, info
            obs, r, term, trunc, _ = out
            return obs, r, bool(term or trunc)
        obs, r, done, _ = out
        return obs, r, bool(done)

    def clone(self) -> "ExternalEnv":
        return ExternalEnv(self._make_env)


_REGISTRY: Dict[str, Any] = {"CartPole-v1": CartPole,
                             "Pendulum-v1": Pendulum}


def register_env(name: str, ctor) -> None:
    """Parity: ray.tune.register_env."""
    _REGISTRY[name] = ctor


def make_env(spec, **config):
    if isinstance(spec, str):
        if spec not in _REGISTRY:
            raise KeyError(
                f"unknown env {spec!r}; registered: {sorted(_REGISTRY)}"
            )
        return _REGISTRY[spec](**config)
    if isinstance(spec, type):
        return spec(**config)
    return spec
