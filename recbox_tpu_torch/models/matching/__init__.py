from recbox_tpu_torch.models.matching.graph import (
    NGCF, LightGCN, build_norm_edges,
)
from recbox_tpu_torch.models.matching.neural_cf import (
    ENMF, FISM, NAIS, NNCF, ConvNCF, NeuMF, PairScoringModel, enmf_loss,
)
from recbox_tpu_torch.models.matching.traditional import (
    ADMMSLIM, EASE, SLIM, ItemKNN, NCEPLRec, Pop, PureSVD, topk_items,
)
from recbox_tpu_torch.models.matching.two_tower import DSSM, MF, YoutubeDNN

__all__ = ["MF", "DSSM", "YoutubeDNN", "LightGCN", "NGCF",
           "build_norm_edges", "PairScoringModel", "NeuMF", "ConvNCF",
           "FISM", "NAIS", "ENMF", "NNCF", "enmf_loss", "Pop", "ItemKNN",
           "EASE", "PureSVD", "SLIM", "ADMMSLIM", "NCEPLRec", "topk_items"]
