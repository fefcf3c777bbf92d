from recbox_tpu_torch.training.checkpoint import (
    load_checkpoint, save_checkpoint,
)
from recbox_tpu_torch.training.monitor import Monitor
from recbox_tpu_torch.training.packed import PackedEmbeddingTrainer
from recbox_tpu_torch.training.recvae import RecVAETrainer
from recbox_tpu_torch.training.sparse import SparseEmbeddingTrainer
from recbox_tpu_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "PackedEmbeddingTrainer",
           "SparseEmbeddingTrainer", "RecVAETrainer", "Monitor",
           "save_checkpoint", "load_checkpoint"]
