"""The port's raw dataset readers (`recbox_tpu_torch/data/readers.py`)
against the JAX package's, on the CPU: `tests/test_readers.py`'s cases on
the port's functions, each output equal to JAX's on the same file (keys,
dtypes and values)."""

import numpy as np
import pytest

from recbox_tpu.data import readers as jreaders
from recbox_tpu_torch.data import readers
from recbox_tpu_torch.data.readers import (
    DATASET_FORMATS, read_dataset, read_ratings,
)


def _same(out, want):
    assert list(out) == list(want)
    for k in want:
        assert out[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(out[k], want[k])


def _read(d, name, **kw):
    out = read_dataset(str(d), name, **kw)
    _same(out, jreaders.read_dataset(str(d), name, **kw))
    return out


def test_presets_equal_jax():
    assert DATASET_FORMATS == jreaders.DATASET_FORMATS
    assert readers.__all__ == jreaders.__all__


def test_ml100k_format(tmp_path):
    (tmp_path / "u.data").write_text("1\t10\t5\t100\n2\t20\t3\t200\n")
    out = _read(tmp_path, "ml-100k")
    assert out["user"].tolist() == ["1", "2"]
    assert out["rating"].tolist() == [5.0, 3.0]
    assert out["timestamp"].tolist() == [100.0, 200.0]


def test_ml1m_double_colon(tmp_path):
    (tmp_path / "ratings.dat").write_text("1::10::4::99\n")
    out = _read(tmp_path, "ml-1m")
    assert out["item"].tolist() == ["10"] and out["rating"][0] == 4.0


def test_header_skip_and_partial_columns(tmp_path):
    p = tmp_path / "x.csv"
    p.write_text("user,item,weight\nu1,i1,7\n")
    out = read_ratings(str(p), sep=",", has_header=True, columns="uir")
    _same(out, jreaders.read_ratings(str(p), sep=",", has_header=True,
                                     columns="uir"))
    assert out["user"][0] == "u1" and out["rating"][0] == 7.0
    assert "timestamp" not in out


def test_yelp_json(tmp_path):
    (tmp_path / "yelp_academic_dataset_review.json").write_text(
        '{"user_id": "ua", "business_id": "b1", "stars": 4.0}\n'
        '{"user_id": "ub", "business_id": "b2", "stars": 2.0}\n')
    out = _read(tmp_path, "yelp")
    assert out["item"].tolist() == ["b1", "b2"]


def test_amazon_json(tmp_path):
    (tmp_path / "reviews.json").write_text(
        '{"reviewerID": "A1", "asin": "B001", "overall": 5.0}\n')
    out = _read(tmp_path, "amazon-beauty")
    assert out["user"][0] == "A1" and out["rating"][0] == 5.0


def test_citeulike_bag(tmp_path):
    (tmp_path / "users.dat").write_text("2 5 9\n1 7\n")
    out = _read(tmp_path, "citeulike")
    assert out["user"].tolist() == ["0", "0", "1"]
    assert out["item"].tolist() == ["5", "9", "7"]


def test_unknown_dataset():
    with pytest.raises(KeyError):
        read_dataset("/nonexistent", "nope")


@pytest.mark.parametrize("name", ["ml-20m", "netflix", "lastfm", "bx",
                                  "epinions", "ml-10m"])
def test_each_delimited_preset_equals_jax(tmp_path, name):
    """A file in each remaining preset's layout (blank lines and missing
    fields included), read whole and cut by ``max_rows``."""
    fname, sep, header, cols = DATASET_FORMATS[name]
    rng = np.random.default_rng(len(name))
    lines = ["h1" + sep + "h2" + sep + "h3"] if header else []
    for i in range(12):
        vals = [str(rng.integers(1, 9)), f"x{rng.integers(0, 5)}",
                f"{rng.integers(1, 6)}.5", str(1000 + i)][:len(cols)]
        if i == 4:
            vals = vals[:2]            # no rating / timestamp field
        lines.append(sep.join(vals))
        if i == 7:
            lines.append("")
    (tmp_path / fname).write_text("\n".join(lines) + "\n")
    out = _read(tmp_path, name)
    assert len(out["user"]) == 12
    _read(tmp_path, name, max_rows=5)
