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

The continuous-control SAC, TD3 and DDPG keep their replay buffer on the
device and, on the card, run each env step and update as a CUDA graph;
the offline BC, CQL and MARWIL learn from an :class:`OfflineDataset`
(``.npz`` files shared with the JAX package); ``MultiAgentPPO`` trains
one policy an agent over a stacked param tree (``TwoAgentReach``).

Not ported yet (ROADMAP.md): the actor-based IMPALA, APPO and APEX-DQN,
the env runners and the evaluation workers; more than one learner
raises.
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms import (A2C, DDPG, DQN, GRPO, PG, PPO,
                                            SAC, TD3, A2CConfig, DDPGConfig,
                                            DQNConfig, GRPOConfig, PGConfig,
                                            PPOConfig, SACConfig, TD3Config)
from ray_tpu_torch.rllib.connectors import (ClipActions, Connector,
                                            ConnectorPipeline,
                                            FlattenObservations, FrameStack,
                                            MeanStdFilter)
from ray_tpu_torch.rllib.env import (CartPole, ExternalEnv, Pendulum,
                                     make_env, register_env)
from ray_tpu_torch.rllib.learner import Learner, LearnerGroup, LearnerSpec
from ray_tpu_torch.rllib.models import ActorCritic
from ray_tpu_torch.rllib.multi_agent import (MultiAgentPPO,
                                             MultiAgentPPOConfig,
                                             TwoAgentReach)
from ray_tpu_torch.rllib.offline import (BC, CQL, MARWIL, BCConfig,
                                         CQLConfig, MARWILConfig,
                                         OfflineDataset)
from ray_tpu_torch.rllib.replay_buffer import (DeviceReplayBuffer,
                                               EpisodeReplayBuffer,
                                               HostReplayBuffer,
                                               PrioritizedDeviceReplayBuffer)

__all__ = [
    "Algorithm", "AlgorithmConfig",
    "PPO", "PPOConfig", "DQN", "DQNConfig", "GRPO", "GRPOConfig",
    "A2C", "A2CConfig", "PG", "PGConfig",
    "SAC", "SACConfig", "TD3", "TD3Config", "DDPG", "DDPGConfig",
    "MultiAgentPPO", "MultiAgentPPOConfig", "TwoAgentReach",
    "BC", "BCConfig", "CQL", "CQLConfig", "MARWIL", "MARWILConfig",
    "OfflineDataset",
    "CartPole", "Pendulum", "ExternalEnv", "make_env", "register_env",
    "ActorCritic", "Learner", "LearnerGroup", "LearnerSpec",
    "DeviceReplayBuffer", "HostReplayBuffer",
    "PrioritizedDeviceReplayBuffer", "EpisodeReplayBuffer",
    "Connector", "ConnectorPipeline", "FlattenObservations",
    "ClipActions", "MeanStdFilter", "FrameStack",
]
