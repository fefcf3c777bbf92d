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

ROADMAP_ITEMS = ("Sequential remainder and zoo", "Ranking zoo remainder",
                 "Matching zoo remainder", "Reranking remainder",
                 "Knowledge", "The full registry")


def test_every_jax_name_is_known():
    assert set(R.MODEL_REGISTRY) | set(R._PENDING) == set(JREG)
    assert not set(R.MODEL_REGISTRY) & set(R._PENDING)
    assert len(R.MODEL_REGISTRY) == 39


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
    assert "din" not in R.list_models()
    assert set(R.list_models()) == set(R.MODEL_REGISTRY)


def test_aliases():
    assert R.get_model("bpr") == R.get_model("MF")
    assert R.get_model("WDL") == R.get_model("WideDeep")
