"""The port's model registry against the JAX package's.

Every name of JAX's registry is the port's: each gives the port's class of
the same name and the stage JAX's gives, looked up case-insensitively
(with the ``BPR`` → MF, ``WDL`` → WideDeep and ``EGR`` → EGREvaluator
aliases), and each of the last seven ported builds; a name JAX's does not
know raises KeyError, as JAX's does. `list_models` lists all 125, as
JAX's does.
"""

import re

import pytest

from recbox_tpu.models.registry import MODEL_REGISTRY as JREG
from recbox_tpu.models.registry import get_model as jget
from recbox_tpu_torch.models import registry as R

# the ranking, multitask and sequential names ported with the sequence CTR
# models, the extended zoo, the multitask models and pretraining
SLICE_NAMES = ("DIN", "BST", "DIEN", "DSIN", "FFM", "FwFM", "FmFM", "FEFM",
               "DeepFEFM", "ONN", "CCPM", "FGCNN", "FLEN", "IFM", "DIFM",
               "EDCN", "MLR", "FiGNN", "EulerNet", "DeepIM", "HFM", "DCNMix",
               "FNN", "DAGFM", "KD_DAGFM", "SharedBottom", "ESMM", "MMOE",
               "PLE", "AITM", "S3Rec", "GRU4RecF")
# the matching zoo's remainder and the knowledge stage (KSR, sequential)
MATCH_KG_NAMES = ("MIND", "ComiRec", "SimpleX", "YoutubeSBC", "MultiVAE",
                  "MacridVAE", "RecVAE", "CDAE", "RaCT", "SGL", "NCL",
                  "DGCF", "SpectralCF", "GCMC", "LINE", "Item2Vec", "CKE",
                  "CFKG", "KTUP", "MKR", "KGCN", "KGNNLS", "KGAT",
                  "RippleNet", "KGIN", "MCCLK", "KSR")


# the reranking remainder, LambdaMART and the exlib passthroughs
LAST_NAMES = ("EGREvaluator", "EGRDiscriminator", "PPOReranker", "EGR",
              "LambdaMART", "XGBoost", "LightGBM")


def test_every_jax_name_is_known():
    assert set(R.MODEL_REGISTRY) == set(JREG)
    assert len(R.MODEL_REGISTRY) == 59 + len(SLICE_NAMES) \
        + len(MATCH_KG_NAMES) + len(LAST_NAMES) == 125


@pytest.mark.parametrize("name", sorted(R.MODEL_REGISTRY))
def test_ported_name_gives_class_and_stage(name):
    cls, stage = R.get_model(name.upper())
    jcls, jstage = jget(name)
    assert stage == jstage
    assert cls.__name__ == jcls.__name__
    assert cls.__module__.startswith("recbox_tpu_torch.")


@pytest.mark.parametrize("name", LAST_NAMES)
def test_last_names_build(name):
    """The seven names that raised until the reranking remainder and the
    exlib passthroughs were ported: each resolves to the port's class at
    JAX's stage and builds (a reranker over 7-wide slots, LambdaMART with
    its defaults; a passthrough raises ImportError naming the port's
    LambdaMART where its package is absent, `test_torch_exlib.py`)."""
    cls, stage = R.get_model(name)
    jcls, jstage = jget(name)
    assert stage == jstage and cls.__name__ == jcls.__name__
    assert cls.__module__.startswith("recbox_tpu_torch.models.")
    if stage == "reranking":
        model = cls(7, device="cpu")
        assert sum(p.numel() for p in model.parameters()) > 0
    elif stage == "ranker":
        assert cls().n_trees == 30
    else:
        try:
            cls()
        except ImportError as err:
            assert "recbox_tpu_torch.models.reranking.lambdamart" \
                in str(err)


def test_unknown_name_raises_key_error_as_jax():
    with pytest.raises(KeyError):
        jget("NoSuchModel")
    with pytest.raises(KeyError, match="not registered"):
        R.get_model("NoSuchModel")


def test_list_models_lists_the_ported_names():
    assert R.list_models("reranking") == [
        "dlcm", "egr", "egrdiscriminator", "egrevaluator", "gsf", "midnn",
        "pporeranker", "prm", "setrank"]
    assert R.list_models("ranker") == ["lambdamart"]
    assert R.list_models("exlib") == ["lightgbm", "xgboost"]
    assert "dcnv2" in R.list_models("ranking")
    assert "din" in R.list_models("ranking")
    assert R.list_models("multitask") == ["aitm", "esmm", "mmoe", "ple",
                                          "sharedbottom"]
    assert set(R.list_models()) == set(R.MODEL_REGISTRY)


def test_aliases():
    assert R.get_model("bpr") == R.get_model("MF")
    assert R.get_model("WDL") == R.get_model("WideDeep")


@pytest.mark.parametrize("name", SLICE_NAMES)
def test_slice_names_resolve_to_port_classes(name):
    """The 32 names of the ranking, multitask and sequential remainder
    give the port's class of that name, at JAX's stage."""
    cls, stage = R.get_model(name)
    assert cls.__name__ == name and stage == jget(name)[1]
    assert cls.__module__.startswith("recbox_tpu_torch.models.")


@pytest.mark.parametrize("name", MATCH_KG_NAMES)
def test_matching_and_knowledge_names_resolve_to_port_classes(name):
    """The 27 names of the matching zoo's remainder and the knowledge
    stage give the port's class of that name, at JAX's stage."""
    cls, stage = R.get_model(name)
    assert cls.__name__ == name and stage == jget(name)[1]
    assert cls.__module__.startswith("recbox_tpu_torch.models.")


def test_no_matching_knowledge_or_sequential_name_is_pending():
    """No name is pending: every stage's names resolve, the registry keeps
    no list of names still to port, and each stage has JAX's names."""
    assert not hasattr(R, "_PENDING")
    for stage in ("matching", "knowledge", "sequential", "ranking",
                  "multitask", "traditional", "reranking", "ranker",
                  "exlib"):
        assert set(R.list_models(stage)) == {
            n for n, (_, s) in JREG.items() if s == stage}, stage
    assert R.get_model("KSR")[1] == "sequential"
