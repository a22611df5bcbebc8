"""Algorithm / AlgorithmConfig — the RLlib driver API (port of
``ray_tpu/rllib/algorithm.py``).

A fluent config builder and a Tune-style trainable with
train/save/restore.  An algorithm runs on one device: the card unless
the config asks for another (``.resources(device="cpu")``; the tests
do).  ``num_tpus`` keeps its meaning, a resource count for a scheduler.
Each algorithm draws its randomness on a seeded CPU ``torch.Generator``
and moves the draws to its device, so one seed gives the same draws on
the CPU and on the card.

``Trainable`` is the port's own copy of the JAX package's small base
(``tune/tuner.py``'s class-trainable protocol).
"""

from __future__ import annotations

import copy
import pickle
import time
from typing import Any, Dict, Optional, Type

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.env import make_env


class Trainable:
    """Class trainable API: subclass with setup/step/save_checkpoint/
    load_checkpoint."""

    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Any:
        return None

    def load_checkpoint(self, checkpoint: Any) -> None:
        pass


class AlgorithmConfig:
    """Fluent config builder; subclasses add algorithm-specific fields."""

    def __init__(self):
        self.env = "CartPole-v1"
        self.env_config: Dict[str, Any] = {}
        self.num_envs = 16
        self.rollout_length = 128
        self.num_env_runners = 0
        self.gamma = 0.99
        self.lr = 3e-4
        self.train_batch_size = 2048
        self.seed = 0
        self.hidden = (64, 64)
        self.num_tpus = 0.0
        self.device = None  # None: the card

    # -- fluent sections (each returns self) --

    def environment(self, env=None, *, env_config: Optional[dict] = None):
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def env_runners(self, *, num_env_runners: int = 0,
                    num_envs: Optional[int] = None,
                    rollout_length: Optional[int] = None):
        self.num_env_runners = num_env_runners
        if num_envs is not None:
            self.num_envs = num_envs
        if rollout_length is not None:
            self.rollout_length = rollout_length
        return self

    def resources(self, *, num_tpus: float = 0.0, device=None):
        """``device``: where the algorithm runs (default the card)."""
        self.num_tpus = num_tpus
        if device is not None:
            self.device = device
        return self

    def debugging(self, *, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in vars(self).items()
                if not k.startswith("_")}

    def update_from_dict(self, d: Dict[str, Any]) -> "AlgorithmConfig":
        for k, v in d.items():
            setattr(self, k, v)
        return self

    @property
    def algo_class(self) -> Type["Algorithm"]:
        raise NotImplementedError

    def build(self) -> "Algorithm":
        return self.algo_class(config=self)


def to_host(tree: Any) -> Any:
    """A state tree with its tensors copied to the CPU."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def to_device(tree: Any, device: torch.device, grad: bool = False) -> Any:
    """A state tree's tensors on ``device`` (float leaves taking
    gradients with ``grad``)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device, grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device, grad) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    t = tree.detach().to(device).clone()
    return t.requires_grad_(grad and t.is_floating_point())


class Algorithm(Trainable):
    """Base class; subclasses implement _setup() and _train_once().

    Runs standalone (``algo = cfg.build(); algo.train()``) or as a Tune
    trainable (setup/step/save_checkpoint/load_checkpoint)."""

    config_class: Type[AlgorithmConfig] = AlgorithmConfig

    def __init__(self, config: Optional[AlgorithmConfig] = None, **kwargs):
        if config is None:
            config = self.config_class()
        if kwargs:  # tune passes a flat dict config
            config = config.copy().update_from_dict(kwargs)
        self.config = config
        self.device = resolve_device(config.device)
        # env=None: algorithms that don't interact with a simulator
        # (LLM RLHF like GRPO — the "env" is the reward function).
        self.env = (make_env(config.env, **config.env_config)
                    if config.env is not None else None)
        self.iteration = 0
        self._timesteps_total = 0
        self._last_episode_return = float("nan")
        self._gen = torch.Generator().manual_seed(int(config.seed))
        self._setup()

    # -- Tune class-trainable protocol ------------------------------------

    def setup(self, config: Dict[str, Any]) -> None:
        self.stop()
        self.__init__(self.config, **config)

    def step(self) -> Dict[str, Any]:
        return self.train()

    def save_checkpoint(self) -> Any:
        # Always bundle the config so from_checkpoint can rebuild the same
        # env/net shapes; non-picklable values (reward_fn lambdas etc.)
        # are dropped — the caller passes those back via
        # from_checkpoint(config=...).
        state = dict(self.get_state())
        if "config" not in state:
            cfg = {}
            for k, v in self.config.to_dict().items():
                try:
                    pickle.dumps(v)
                except Exception:
                    continue
                cfg[k] = v
            state["config"] = cfg
        return pickle.dumps(state)

    def load_checkpoint(self, checkpoint: Any) -> None:
        self.set_state(pickle.loads(checkpoint))

    # -- RLlib surface ------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        metrics = self._train_once()
        self.iteration += 1
        self._timesteps_total += int(metrics.pop("_timesteps", 0))
        ret = metrics.get("episode_return_mean")
        if ret is not None and ret == ret:  # not NaN
            self._last_episode_return = ret
        else:
            metrics["episode_return_mean"] = self._last_episode_return
        metrics.update(
            training_iteration=self.iteration,
            timesteps_total=self._timesteps_total,
            time_this_iter_s=time.perf_counter() - t0,
        )
        return metrics

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        raise NotImplementedError

    def stop(self) -> None:
        pass

    def get_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def set_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            f.write(self.save_checkpoint())
        return path

    @classmethod
    def from_checkpoint(cls, path: str, config=None) -> "Algorithm":
        with open(path, "rb") as f:
            state = pickle.loads(f.read())
        if config is None and "config" in state:
            # Rebuild the saved config so the env / net shapes / hparams
            # match the checkpointed params.
            config = cls.config_class().update_from_dict(state["config"])
        algo = cls(config=config)
        algo.set_state(state)
        return algo

    # -- subclass hooks ----------------------------------------------------

    def _setup(self) -> None:
        raise NotImplementedError

    def _train_once(self) -> Dict[str, Any]:
        raise NotImplementedError


def scalars(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Device metrics as host floats, in one copy (one sync)."""
    dev = next((v.device for v in metrics.values()
                if isinstance(v, torch.Tensor)), None)
    vals = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=dev).reshape(())
                        for v in metrics.values()])
    return dict(zip(metrics, vals.cpu().tolist()))
