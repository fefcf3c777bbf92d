"""The port's dataset adapters against the JAX package's, on the CPU.

The same staged atomic files go through each package's loader and
adapter: `build_kg_sequential`'s splits, knowledge graph and neighbour
tables, and `atomic_to_feature_matrix`'s matrix, labels and column names
(side tables joined, an id absent from a side table, a token column over
the threshold, a string token column, a sequence column) are equal array
for array.
"""

import numpy as np
import pytest

from recbox_tpu.data import adapters as J
from recbox_tpu.data.atomic import load_atomic_dataset as jload
from recbox_tpu_torch.data import adapters as P
from recbox_tpu_torch.data.atomic import load_atomic_dataset as pload
from test_adapters import _write_kg_dataset


def _equal(got, want, what):
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}[{k}]")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("kw", [dict(max_len=6, n_neighbors=4),
                                dict(max_len=3, n_neighbors=2, seed=5,
                                     min_hist=2)])
def test_build_kg_sequential_equals_jax(tmp_path, kw):
    _write_kg_dataset(tmp_path, n_users=15, n_items=9)
    want = J.build_kg_sequential(jload(str(tmp_path), "t"), **kw)
    got = P.build_kg_sequential(pload(str(tmp_path), "t"), **kw)
    for i, what in enumerate(("train", "valid", "test")):
        _equal(got[i], want[i], what)
    jkg, pkg = want[3], got[3]
    for field in ("heads", "relations", "tails"):
        _equal(getattr(pkg, field), getattr(jkg, field), field)
    assert (pkg.n_entities, pkg.n_relations, pkg.n_items) == \
        (jkg.n_entities, jkg.n_relations, jkg.n_items)
    _equal(got[4], want[4], "model_kwargs")


def _stage_side_tables(root):
    (root / "d.inter").write_text(
        "user_id:token\titem_id:token\trating:float\tdevice:token\t"
        "tags:token_seq\twide:token\n" + "".join(
            f"u{k % 5}\ti{k % 4}\t{float(k % 2)}\t{'phone' if k % 3 else 'pc'}"
            f"\tt{k % 2} t{k % 3}\tw{k}\n" for k in range(30)))
    (root / "d.user").write_text(
        "user_id:token\tage:float\tcity:token\n"
        + "".join(f"u{k}\t{20.0 + k}\tc{k % 2}\n" for k in range(4)))
    (root / "d.item").write_text(
        "item_id:token\tprice:float\tbrand:token\n"
        + "".join(f"i{k}\t{5.0 + k}\tb{k % 3}\n" for k in range(4)))


@pytest.mark.parametrize("kw", [dict(), dict(token_num_threshold=10),
                                dict(drop_fields=("age",))])
def test_atomic_to_feature_matrix_equals_jax(tmp_path, kw):
    _stage_side_tables(tmp_path)
    jX, jy, jnames = J.atomic_to_feature_matrix(
        jload(str(tmp_path), "d"), label_field="rating", **kw)
    pX, py, pnames = P.atomic_to_feature_matrix(
        pload(str(tmp_path), "d"), label_field="rating", **kw)
    assert pnames == jnames
    assert pX.dtype == jX.dtype and py.dtype == jy.dtype
    np.testing.assert_array_equal(pX, jX)
    np.testing.assert_array_equal(py, jy)
    with pytest.raises(KeyError):
        P.atomic_to_feature_matrix(pload(str(tmp_path), "d"),
                                   label_field="clicks")
