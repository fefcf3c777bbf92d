from recbox_tpu_torch.training.packed import PackedEmbeddingTrainer
from recbox_tpu_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "PackedEmbeddingTrainer"]
