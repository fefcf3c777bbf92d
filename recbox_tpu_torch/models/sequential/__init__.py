from recbox_tpu_torch.models.sequential.models import (
    NARM, STAMP, Caser, GRU4Rec, NextItNet, SASRec, SequentialRecommender,
    right_align_to_left,
)

__all__ = ["SequentialRecommender", "SASRec", "GRU4Rec", "NARM", "STAMP",
           "Caser", "NextItNet", "right_align_to_left"]
