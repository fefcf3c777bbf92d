from recbox_tpu_torch.models.base import (
    MatchingModel, RankingModel, similarity_scores,
)
from recbox_tpu_torch.models.matching import DSSM, MF, YoutubeDNN
from recbox_tpu_torch.models.ranking import DeepFM
from recbox_tpu_torch.models.sequential import SASRec, SequentialRecommender
from recbox_tpu_torch.models.registry import (
    MODEL_REGISTRY, get_model, list_models, register_model,
)

__all__ = ["get_model", "list_models", "register_model", "MODEL_REGISTRY",
           "MatchingModel", "RankingModel", "similarity_scores", "MF", "DSSM",
           "YoutubeDNN", "DeepFM", "SequentialRecommender", "SASRec"]
