"""Training: AdamW (fp32 or int8 moments), atomic checkpoints, resumable
data and the trainer.  Counterpart of ``repro/training``."""
from repro_torch.training.optimizer import (
    adamw_init,
    adamw_update,
    OptimizerConfig,
)
from repro_torch.training.trainer import Trainer, TrainConfig, make_train_step
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import TokenStream, DistillBatcher
