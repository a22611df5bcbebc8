from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.grpo import GRPO, GRPOConfig
from ray_tpu_torch.rllib.algorithms.pg import PG, PGConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig

__all__ = ["A2C", "A2CConfig", "DQN", "DQNConfig", "GRPO", "GRPOConfig",
           "PG", "PGConfig", "PPO", "PPOConfig"]
