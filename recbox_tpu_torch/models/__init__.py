from recbox_tpu_torch.models.base import MatchingModel, similarity_scores
from recbox_tpu_torch.models.matching import DSSM, MF, YoutubeDNN

__all__ = ["MatchingModel", "similarity_scores", "MF", "DSSM", "YoutubeDNN"]
