from recbox_tpu_torch.data.atomic import AtomicDataset, load_atomic_dataset
from recbox_tpu_torch.data.interactions import InteractionDataset
from recbox_tpu_torch.data.loader import (
    MASK_KEY, ArrayLoader, MatchingLoader, num_batches,
)
from recbox_tpu_torch.data.sampling import (
    AliasTable, popularity_distribution, sample_negatives,
)
from recbox_tpu_torch.data.shards import (
    ShardLoader, load_shards, save_shards,
)
from recbox_tpu_torch.data.sequential import (
    build_sliding_windows, group_user_sequences, leave_one_out_split,
)

__all__ = ["ArrayLoader", "MatchingLoader", "MASK_KEY", "num_batches",
           "AliasTable", "popularity_distribution", "sample_negatives",
           "ShardLoader", "save_shards", "load_shards", "AtomicDataset",
           "InteractionDataset", "load_atomic_dataset",
           "build_sliding_windows", "group_user_sequences",
           "leave_one_out_split"]
