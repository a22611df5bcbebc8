from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, DDPGConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.grpo import GRPO, GRPOConfig
from ray_tpu_torch.rllib.algorithms.pg import PG, PGConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.algorithms.td3 import TD3, TD3Config

__all__ = ["A2C", "A2CConfig", "DDPG", "DDPGConfig", "DQN", "DQNConfig",
           "GRPO", "GRPOConfig", "PG", "PGConfig", "PPO", "PPOConfig",
           "SAC", "SACConfig", "TD3", "TD3Config"]
