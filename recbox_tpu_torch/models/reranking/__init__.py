from recbox_tpu_torch.models.reranking.models import (
    DLCM, GSF, PRM, MiDNN, SetRank, listwise_bce, listwise_softmax_ce,
)

__all__ = ["PRM", "DLCM", "SetRank", "MiDNN", "GSF", "listwise_bce",
           "listwise_softmax_ce"]
