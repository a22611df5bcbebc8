"""ray_tpu_torch.rllib — reinforcement learning on one device (port of
``ray_tpu/rllib``, its single-device algorithms).

Envs step as batched tensor ops on the device, rollouts are Python
loops over them, and every update is ``torch.autograd`` plus optax's
Adam rounding (``learner.adam``).  GRPO trains a Llama policy, whose
attention runs the flash kernels on the card.  Each algorithm draws its
randomness first, on a seeded CPU generator, and computes from the
draws, so a seed gives the same run on the CPU and on the card.

    from ray_tpu_torch.rllib import PPOConfig
    algo = PPOConfig().environment("CartPole-v1").build()   # the card
    for _ in range(10):
        print(algo.train()["episode_return_mean"])

Not ported yet (ROADMAP.md): SAC, TD3, DDPG, offline (BC, CQL, MARWIL),
multi-agent, and the actor-based IMPALA, APPO, APEX-DQN, env runners
and evaluation workers; more than one learner raises.
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms import (A2C, DQN, GRPO, PG, PPO,
                                            A2CConfig, DQNConfig,
                                            GRPOConfig, PGConfig, PPOConfig)
from ray_tpu_torch.rllib.connectors import (ClipActions, Connector,
                                            ConnectorPipeline,
                                            FlattenObservations, FrameStack,
                                            MeanStdFilter)
from ray_tpu_torch.rllib.env import (CartPole, ExternalEnv, Pendulum,
                                     make_env, register_env)
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup, LearnerSpec
from ray_tpu_torch.rllib.models import ActorCritic
from ray_tpu_torch.rllib.replay_buffer import (DeviceReplayBuffer,
                                               EpisodeReplayBuffer,
                                               HostReplayBuffer,
                                               PrioritizedDeviceReplayBuffer)

__all__ = [
    "Algorithm", "AlgorithmConfig",
    "PPO", "PPOConfig", "DQN", "DQNConfig", "GRPO", "GRPOConfig",
    "A2C", "A2CConfig", "PG", "PGConfig",
    "CartPole", "Pendulum", "ExternalEnv", "make_env", "register_env",
    "ActorCritic", "Learner", "LearnerGroup", "LearnerSpec",
    "DeviceReplayBuffer", "HostReplayBuffer",
    "PrioritizedDeviceReplayBuffer", "EpisodeReplayBuffer",
    "Connector", "ConnectorPipeline", "FlattenObservations",
    "ClipActions", "MeanStdFilter", "FrameStack",
]
