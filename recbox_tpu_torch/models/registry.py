"""Model registry: name → (class, stage), the `get_model` analog.

Counterpart of `recbox_tpu/models/registry.py` (:29-184) over the ported
classes. The registry knows every name of JAX's: `get_model` returns
``(class, stage)`` for a ported name, with the same case-insensitive
lookup and the ``BPR`` → ``MF`` and ``WDL`` → ``WideDeep`` aliases; for a
name not ported yet it raises NotImplementedError naming the
`ROADMAP.md` Queue A item that ports it; an unknown name raises KeyError.
`list_models` lists the ported names only (JAX's lists all of its).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Type

from recbox_tpu_torch.models.matching import (
    DSSM, ENMF, FISM, MF, NAIS, NNCF, ADMMSLIM, EASE, ConvNCF, ItemKNN,
    LightGCN, NCEPLRec, NeuMF, NGCF, Pop, PureSVD, SLIM, YoutubeDNN,
)
from recbox_tpu_torch.models.ranking.ctr import (
    AFM, DCN, DNN, FM, LR, NFM, PNN, AutoInt, DCNv2, DeepFM, FiBiNET,
    WideDeep, xDeepFM,
)
from recbox_tpu_torch.models.reranking.models import (
    DLCM, GSF, PRM, MiDNN, SetRank,
)
from recbox_tpu_torch.models.sequential import SASRec

__all__ = ["MODEL_REGISTRY", "get_model", "register_model", "list_models"]

MODEL_REGISTRY: Dict[str, Tuple[Type, str]] = {}

# the JAX registry's names the port does not have yet: (stage, the
# ROADMAP.md Queue A item that ports them)
_SEQ, _RANK, _MATCH = ("Sequential remainder and zoo", "Ranking zoo remainder",
                       "Matching zoo remainder")
_RERANK, _KG, _FULL = ("Reranking remainder", "Knowledge",
                       "The full registry")
_PENDING: Dict[str, Tuple[str, str]] = {}
for _names, _stage, _item in [
        (("SharedBottom", "ESMM", "MMOE", "PLE", "AITM"), "multitask", _RANK),
        (("GRU4Rec", "NARM", "STAMP", "Caser", "NextItNet", "BERT4Rec",
          "FPMC", "TransRec", "HGN", "SHAN", "FOSSIL", "HRM", "NPE", "CORE",
          "LightSANs", "FDSA", "RepeatNet", "SINE", "SRGNN", "GCSAN",
          "S3Rec", "GRU4RecF"), "sequential", _SEQ),
        (("KSR",), "sequential", _KG),
        (("DIN", "BST", "DIEN", "DSIN", "FFM", "FwFM", "FmFM", "FEFM",
          "DeepFEFM", "ONN", "CCPM", "FGCNN", "FLEN", "IFM", "DIFM", "EDCN",
          "MLR", "FiGNN", "EulerNet", "DeepIM", "HFM", "DCNMix", "FNN",
          "DAGFM", "KD_DAGFM"), "ranking", _RANK),
        (("MIND", "ComiRec", "SimpleX", "YoutubeSBC", "MultiVAE",
          "MacridVAE", "RecVAE", "CDAE", "RaCT", "SGL", "NCL", "DGCF",
          "SpectralCF", "GCMC", "LINE", "Item2Vec"), "matching", _MATCH),
        (("CKE", "CFKG", "KTUP", "MKR", "KGCN", "KGNNLS", "KGAT",
          "RippleNet", "KGIN", "MCCLK"), "knowledge", _KG),
        (("EGREvaluator", "EGRDiscriminator", "PPOReranker", "EGR"),
         "reranking", _RERANK),
        (("LambdaMART",), "ranker", _RERANK),
        (("XGBoost", "LightGBM"), "exlib", _FULL)]:
    for _name in _names:
        _PENDING[_name.lower()] = (_stage, _item)


def register_model(name: str, cls: Type, stage: str) -> None:
    MODEL_REGISTRY[name.lower()] = (cls, stage)
    _PENDING.pop(name.lower(), None)


def get_model(name: str) -> Tuple[Type, str]:
    key = name.lower()
    if key in MODEL_REGISTRY:
        return MODEL_REGISTRY[key]
    if key in _PENDING:
        stage, item = _PENDING[key]
        raise NotImplementedError(
            f"model {name!r} (stage {stage!r}) is not ported yet "
            f"(ROADMAP.md, Queue A: \"{item}\")")
    raise KeyError(
        f"model {name!r} not registered; known: {sorted(MODEL_REGISTRY)}")


def list_models(stage: Optional[str] = None) -> List[str]:
    """The ported names (of ``stage``), sorted."""
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
register_model("SASRec", SASRec, "sequential")
for _name, _cls in [("PRM", PRM), ("DLCM", DLCM), ("SetRank", SetRank),
                    ("MiDNN", MiDNN), ("GSF", GSF)]:
    register_model(_name, _cls, "reranking")
