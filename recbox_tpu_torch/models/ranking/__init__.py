from recbox_tpu_torch.models.ranking.ctr import (
    AFM, DCN, DNN, FM, LR, NFM, PNN, AutoInt, DCNv2, DeepFM, FiBiNET,
    WideDeep, xDeepFM,
)

__all__ = ["LR", "FM", "DNN", "WideDeep", "DeepFM", "NFM", "AFM", "DCN",
           "DCNv2", "xDeepFM", "AutoInt", "PNN", "FiBiNET"]
