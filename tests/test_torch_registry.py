"""The port's model registry against the JAX package's.

Every name of JAX's registry is known to the port's: a ported name gives
the port's class of the same name and the stage JAX's gives, looked up
case-insensitively (with the ``BPR`` → MF and ``WDL`` → WideDeep
aliases); a name not ported yet raises NotImplementedError naming its
`ROADMAP.md` Queue A item by title, and a name JAX's does not know raises
KeyError, as JAX's does. `list_models` lists the ported names (JAX's lists
all of its own: a recorded divergence).
"""

import re

import pytest

from recbox_tpu.models.registry import MODEL_REGISTRY as JREG
from recbox_tpu.models.registry import get_model as jget
from recbox_tpu_torch.models import registry as R

ROADMAP_ITEMS = ("Matching zoo remainder", "Reranking remainder",
                 "Knowledge", "The full registry")
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


def test_every_jax_name_is_known():
    assert set(R.MODEL_REGISTRY) | set(R._PENDING) == set(JREG)
    assert not set(R.MODEL_REGISTRY) & set(R._PENDING)
    assert len(R.MODEL_REGISTRY) == 59 + len(SLICE_NAMES) \
        + len(MATCH_KG_NAMES) == 118


@pytest.mark.parametrize("name", sorted(R.MODEL_REGISTRY))
def test_ported_name_gives_class_and_stage(name):
    cls, stage = R.get_model(name.upper())
    jcls, jstage = jget(name)
    assert stage == jstage
    assert cls.__name__ == jcls.__name__
    assert cls.__module__.startswith("recbox_tpu_torch.")


@pytest.mark.parametrize("name", sorted(R._PENDING))
def test_unported_name_raises_naming_its_item(name):
    with pytest.raises(NotImplementedError) as err:
        R.get_model(name)
    item = re.search(r'Queue A: "([^"]+)"', str(err.value)).group(1)
    assert item in ROADMAP_ITEMS
    assert jget(name)[1] in str(err.value)


def test_unknown_name_raises_key_error_as_jax():
    with pytest.raises(KeyError):
        jget("NoSuchModel")
    with pytest.raises(KeyError, match="not registered"):
        R.get_model("NoSuchModel")


def test_list_models_lists_the_ported_names():
    assert R.list_models("reranking") == ["dlcm", "gsf", "midnn", "prm",
                                          "setrank"]
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
    """Only the reranking remainder and the exlib boosters are not ported:
    no name of the matching, knowledge or sequential stages raises."""
    left = {n for n, (stage, _) in R._PENDING.items()
            if stage in ("matching", "knowledge", "sequential", "ranking",
                         "multitask", "traditional")}
    assert not left
    assert set(R._PENDING) == {"egrevaluator", "egrdiscriminator",
                               "pporeranker", "egr", "lambdamart",
                               "xgboost", "lightgbm"}
    assert R.get_model("KSR")[1] == "sequential"
