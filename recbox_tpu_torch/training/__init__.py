from recbox_tpu_torch.training.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from recbox_tpu_torch.training.monitor import Monitor
from recbox_tpu_torch.training.packed import PackedEmbeddingTrainer
from recbox_tpu_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "PackedEmbeddingTrainer", "Monitor",
           "save_checkpoint", "load_checkpoint"]
