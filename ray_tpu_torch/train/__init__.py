from ray_tpu_torch.train import backend, zero
from ray_tpu_torch.train.checkpoint import CheckpointManager
from ray_tpu_torch.train.optim8 import adamw8bit, scale_by_adam8bit
from ray_tpu_torch.train.state import (
    AdamW,
    TrainState,
    create_train_state,
    default_optimizer,
)
from ray_tpu_torch.train.step import compile_train_step, make_train_step
from ray_tpu_torch.train.trainer import (
    MeshSpec,
    Result,
    RunConfig,
    ScalingConfig,
    TorchTrainer,
    TrainerConfig,
)

__all__ = [
    "AdamW",
    "backend",
    "zero",
    "CheckpointManager",
    "MeshSpec",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchTrainer",
    "TrainState",
    "TrainerConfig",
    "adamw8bit",
    "compile_train_step",
    "create_train_state",
    "default_optimizer",
    "make_train_step",
    "scale_by_adam8bit",
]
