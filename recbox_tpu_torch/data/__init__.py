from recbox_tpu_torch.data.atomic import AtomicDataset, load_atomic_dataset
from recbox_tpu_torch.data.interactions import InteractionDataset
from recbox_tpu_torch.data.loader import MASK_KEY, ArrayLoader, num_batches
from recbox_tpu_torch.data.sequential import (
    build_sliding_windows, group_user_sequences, leave_one_out_split,
)

__all__ = ["ArrayLoader", "MASK_KEY", "num_batches", "AtomicDataset",
           "InteractionDataset", "load_atomic_dataset",
           "build_sliding_windows", "group_user_sequences",
           "leave_one_out_split"]
