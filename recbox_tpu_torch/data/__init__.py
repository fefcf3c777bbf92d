from recbox_tpu_torch.data.loader import MASK_KEY, ArrayLoader
from recbox_tpu_torch.data.sequential import (
    build_sliding_windows, group_user_sequences, leave_one_out_split,
)

__all__ = ["ArrayLoader", "MASK_KEY", "build_sliding_windows",
           "group_user_sequences", "leave_one_out_split"]
