from recbox_tpu_torch.models.sequential.extended import (
    CORE, FDSA, FOSSIL, FPMC, HGN, HRM, NPE, SHAN, SINE, BERT4Rec, LightSANs,
    RepeatNet, TransRec,
)
from recbox_tpu_torch.models.sequential.models import (
    NARM, STAMP, Caser, GRU4Rec, NextItNet, SASRec, SequentialRecommender,
    right_align_to_left,
)
from recbox_tpu_torch.models.sequential.pretrain import GRU4RecF, S3Rec
from recbox_tpu_torch.models.sequential.session_graph import (
    GCSAN, SRGNN, session_adjacency,
)

__all__ = ["SequentialRecommender", "SASRec", "GRU4Rec", "NARM", "STAMP",
           "Caser", "NextItNet", "BERT4Rec", "FPMC", "TransRec", "HGN",
           "SHAN", "FOSSIL", "HRM", "NPE", "CORE", "LightSANs", "FDSA",
           "RepeatNet", "SINE", "SRGNN", "GCSAN", "S3Rec", "GRU4RecF",
           "right_align_to_left", "session_adjacency"]
