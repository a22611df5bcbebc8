"""DDPG — deterministic policy gradient for continuous control (port of
``ray_tpu/rllib/algorithms/ddpg.py``).

The ``twin_q=False`` / no-smoothing / no-delay point of TD3 (TD3 is
DDPG plus those three fixes), sharing its buffer on the device and its
steps as CUDA graphs on the card.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.td3 import TD3, TD3Config


class DDPGConfig(TD3Config):
    def __init__(self):
        super().__init__()
        self.twin_q = False        # single critic
        self.target_noise = 0.0    # no target-policy smoothing
        self.policy_delay = 1      # actor updates every critic step

    @property
    def algo_class(self):
        return DDPG


class DDPG(TD3):
    config_class = DDPGConfig
