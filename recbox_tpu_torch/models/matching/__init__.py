from recbox_tpu_torch.models.matching.autoencoder import (
    CDAE, MacridVAE, MultiVAE, RaCT, RecVAE, build_history_matrix, cdae_loss,
    log_norm_pdf, multivae_loss, ract_critic_features, recvae_loss,
)
from recbox_tpu_torch.models.matching.graph import (
    NGCF, LightGCN, build_norm_edges,
)
from recbox_tpu_torch.models.matching.graph_extended import (
    DGCF, GCMC, LINE, NCL, SGL, SpectralCF, infonce, infonce_all,
    kmeans_prototypes,
)
from recbox_tpu_torch.models.matching.item2vec import (
    Item2Vec, build_skipgram_pairs, sgns_loss,
)
from recbox_tpu_torch.models.matching.multi_interest import (
    MIND, ComiRec, SimpleX, YoutubeSBC, sampled_softmax_inbatch_loss,
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
           "EASE", "PureSVD", "SLIM", "ADMMSLIM", "NCEPLRec", "topk_items",
           "MIND", "ComiRec", "SimpleX", "YoutubeSBC",
           "sampled_softmax_inbatch_loss", "MultiVAE", "MacridVAE", "RecVAE",
           "CDAE", "RaCT", "multivae_loss", "cdae_loss", "recvae_loss",
           "log_norm_pdf", "ract_critic_features", "build_history_matrix",
           "SGL", "NCL", "DGCF", "SpectralCF", "GCMC", "LINE", "infonce",
           "infonce_all", "kmeans_prototypes", "Item2Vec", "sgns_loss",
           "build_skipgram_pairs"]
