"""Model registry: name → (class, stage), the `get_model` analog.

Counterpart of `recbox_tpu/models/registry.py` (:29-184) over the ported
classes: every one of JAX's 125 names, at JAX's stage. `get_model` returns
``(class, stage)``, with the same case-insensitive lookup and the ``BPR``
→ ``MF``, ``WDL`` → ``WideDeep`` and ``EGR`` → ``EGREvaluator`` aliases;
an unknown name raises KeyError. LambdaMART (stage 'ranker') and the
XGBoost / LightGBM passthroughs (stage 'exlib') are host models.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Type

from recbox_tpu_torch.models import knowledge, matching, ranking
from recbox_tpu_torch.models.exlib import (
    LightGBMRecommender, XGBoostRecommender,
)
from recbox_tpu_torch.models.matching import (
    DSSM, ENMF, FISM, MF, NAIS, NNCF, ADMMSLIM, EASE, ConvNCF, ItemKNN,
    LightGCN, NCEPLRec, NeuMF, NGCF, Pop, PureSVD, SLIM, YoutubeDNN,
)
from recbox_tpu_torch.models.multitask import (
    AITM, ESMM, MMOE, PLE, SharedBottom,
)
from recbox_tpu_torch.models.ranking.ctr import (
    AFM, DCN, DNN, FM, LR, NFM, PNN, AutoInt, DCNv2, DeepFM, FiBiNET,
    WideDeep, xDeepFM,
)
from recbox_tpu_torch.models.reranking.lambdamart import LambdaMART
from recbox_tpu_torch.models.reranking.models import (
    DLCM, GSF, PRM, MiDNN, SetRank,
)
from recbox_tpu_torch.models.reranking.rl import (
    EGRDiscriminator, EGREvaluator, PPOReranker,
)
from recbox_tpu_torch.models.sequential import (
    CORE, FDSA, FOSSIL, FPMC, GCSAN, HGN, HRM, NARM, NPE, SHAN, SINE, SRGNN,
    STAMP, BERT4Rec, Caser, GRU4Rec, GRU4RecF, LightSANs, NextItNet,
    RepeatNet, S3Rec, SASRec, TransRec,
)

__all__ = ["MODEL_REGISTRY", "get_model", "register_model", "list_models"]

MODEL_REGISTRY: Dict[str, Tuple[Type, str]] = {}


def register_model(name: str, cls: Type, stage: str) -> None:
    MODEL_REGISTRY[name.lower()] = (cls, stage)


def get_model(name: str) -> Tuple[Type, str]:
    key = name.lower()
    if key in MODEL_REGISTRY:
        return MODEL_REGISTRY[key]
    raise KeyError(
        f"model {name!r} not registered; known: {sorted(MODEL_REGISTRY)}")


def list_models(stage: Optional[str] = None) -> List[str]:
    """The registered names (of ``stage``), sorted."""
    return sorted(n for n, (_, s) in MODEL_REGISTRY.items()
                  if stage is None or s == stage)


for _name, _cls in [("MF", MF), ("DSSM", DSSM), ("YoutubeDNN", YoutubeDNN),
                    ("LightGCN", LightGCN), ("NGCF", NGCF), ("BPR", MF),
                    ("NeuMF", NeuMF), ("ConvNCF", ConvNCF), ("NAIS", NAIS),
                    ("FISM", FISM), ("ENMF", ENMF), ("NNCF", NNCF)]:
    register_model(_name, _cls, "matching")
for _name, _cls in [("Pop", Pop), ("ItemKNN", ItemKNN), ("EASE", EASE),
                    ("PureSVD", PureSVD), ("SLIM", SLIM),
                    ("ADMMSLIM", ADMMSLIM), ("NCEPLRec", NCEPLRec)]:
    register_model(_name, _cls, "traditional")
for _name, _cls in [("LR", LR), ("FM", FM), ("DNN", DNN),
                    ("WideDeep", WideDeep), ("DeepFM", DeepFM), ("NFM", NFM),
                    ("AFM", AFM), ("DCN", DCN), ("DCNv2", DCNv2),
                    ("xDeepFM", xDeepFM), ("AutoInt", AutoInt), ("PNN", PNN),
                    ("FiBiNET", FiBiNET), ("WDL", WideDeep)]:
    register_model(_name, _cls, "ranking")
# the sequence CTR models, the extended zoo and DAGFM / KD_DAGFM
for _name in ("DIN", "BST", "DIEN", "DSIN", "FFM", "FwFM", "FmFM", "FEFM",
              "DeepFEFM", "ONN", "CCPM", "FGCNN", "FLEN", "IFM", "DIFM",
              "EDCN", "MLR", "FiGNN", "EulerNet", "DeepIM", "HFM", "DCNMix",
              "FNN", "DAGFM", "KD_DAGFM"):
    register_model(_name, getattr(ranking, _name), "ranking")
for _name, _cls in [("SharedBottom", SharedBottom), ("ESMM", ESMM),
                    ("MMOE", MMOE), ("PLE", PLE), ("AITM", AITM)]:
    register_model(_name, _cls, "multitask")
for _name, _cls in [("SASRec", SASRec), ("GRU4Rec", GRU4Rec), ("NARM", NARM),
                    ("STAMP", STAMP), ("Caser", Caser),
                    ("NextItNet", NextItNet), ("BERT4Rec", BERT4Rec),
                    ("FPMC", FPMC), ("TransRec", TransRec), ("HGN", HGN),
                    ("SHAN", SHAN), ("FOSSIL", FOSSIL), ("HRM", HRM),
                    ("NPE", NPE), ("CORE", CORE), ("LightSANs", LightSANs),
                    ("FDSA", FDSA), ("RepeatNet", RepeatNet),
                    ("SINE", SINE), ("SRGNN", SRGNN), ("GCSAN", GCSAN),
                    ("S3Rec", S3Rec), ("GRU4RecF", GRU4RecF)]:
    register_model(_name, _cls, "sequential")
register_model("KSR", knowledge.KSR, "sequential")
# the matching zoo's remainder and the knowledge models
for _name in ("MIND", "ComiRec", "SimpleX", "YoutubeSBC", "MultiVAE",
              "MacridVAE", "RecVAE", "CDAE", "RaCT", "SGL", "NCL", "DGCF",
              "SpectralCF", "GCMC", "LINE", "Item2Vec"):
    register_model(_name, getattr(matching, _name), "matching")
for _name in ("CKE", "CFKG", "KTUP", "MKR", "KGCN", "KGNNLS", "KGAT",
              "RippleNet", "KGIN", "MCCLK"):
    register_model(_name, getattr(knowledge, _name), "knowledge")
for _name, _cls in [("PRM", PRM), ("DLCM", DLCM), ("SetRank", SetRank),
                    ("MiDNN", MiDNN), ("GSF", GSF),
                    ("EGREvaluator", EGREvaluator),
                    ("EGRDiscriminator", EGRDiscriminator),
                    ("PPOReranker", PPOReranker), ("EGR", EGREvaluator)]:
    register_model(_name, _cls, "reranking")
register_model("LambdaMART", LambdaMART, "ranker")
register_model("XGBoost", XGBoostRecommender, "exlib")
register_model("LightGBM", LightGBMRecommender, "exlib")
