from recbox_tpu_torch.models.base import (
    MatchingModel, RankingModel, similarity_scores,
)
from recbox_tpu_torch.models.matching import DSSM, MF, YoutubeDNN
from recbox_tpu_torch.models.ranking import DeepFM
from recbox_tpu_torch.models.sequential import SASRec, SequentialRecommender

__all__ = ["MatchingModel", "RankingModel", "similarity_scores", "MF", "DSSM",
           "YoutubeDNN", "DeepFM", "SequentialRecommender", "SASRec"]
