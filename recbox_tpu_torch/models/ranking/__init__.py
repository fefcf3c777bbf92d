from recbox_tpu_torch.models.ranking.ctr import (
    AFM, DCN, DNN, FM, LR, NFM, PNN, AutoInt, DCNv2, DeepFM, FiBiNET,
    WideDeep, xDeepFM,
)
from recbox_tpu_torch.models.ranking.ctr_extended import (
    CCPM, DIFM, EDCN, FFM, FGCNN, FLEN, FNN, HFM, IFM, MLR, ONN, DCNMix,
    DeepFEFM, DeepIM, EulerNet, FEFM, FiGNN, FmFM, FwFM,
)
from recbox_tpu_torch.models.ranking.distill import (
    DAGFM, KD_DAGFM, distillation_loss,
)
from recbox_tpu_torch.models.ranking.sequence_ctr import BST, DIEN, DIN, DSIN

__all__ = ["LR", "FM", "DNN", "WideDeep", "DeepFM", "NFM", "AFM", "DCN",
           "DCNv2", "xDeepFM", "AutoInt", "PNN", "FiBiNET", "FFM", "FwFM",
           "FmFM", "FEFM", "DeepFEFM", "ONN", "CCPM", "FGCNN", "FLEN", "IFM",
           "DIFM", "EDCN", "MLR", "FiGNN", "EulerNet", "DeepIM", "HFM",
           "DCNMix", "FNN", "DAGFM", "KD_DAGFM", "distillation_loss", "DIN",
           "BST", "DIEN", "DSIN"]
