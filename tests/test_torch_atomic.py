"""The port's atomic-file loader and interaction table against the JAX
package's, on the CPU, and the quality exit's data generators against the
JAX package's own.

Files are written in ``tmp_path`` (typed headers, token / float /
token_seq / float_seq columns, empty and "None" values, a .user and an
.item file sharing the vocabularies); both packages load them, and every
column, vocabulary and derived array must be equal (exactly: the same
numpy code on the same text). The generators in
`recbox_tpu_torch/tools/quality_exit.py` must write byte for byte the files
that `tools/parity_gen_ctr.py` and `tools/parity_gen_seq.py` write (run in
a subprocess with their output directory pointed into ``tmp_path``).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from recbox_tpu.data import atomic as jatomic
from recbox_tpu.data.interactions import InteractionDataset as JInter
from recbox_tpu_torch.data import atomic as patomic
from recbox_tpu_torch.data.interactions import InteractionDataset as PInter
from recbox_tpu_torch.tools import quality_exit

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _write(tmp_path):
    rng = np.random.default_rng(0)
    lines = ["user_id:token\titem_id:token\trating:float\ttimestamp:float"]
    for k in range(300):
        rating = "" if k % 41 == 0 else ("None" if k % 53 == 0
                                         else f"{rng.integers(1, 6)}")
        lines.append(f"u{rng.integers(0, 30)}\ti{rng.integers(0, 50)}\t"
                     f"{rating}\t{rng.integers(0, 10 ** 6)}")
    (tmp_path / "d.inter").write_text("\n".join(lines) + "\n\n")
    users = ["user_id:token\tage:float\ttags:token_seq"]
    users += [f"u{u}\t{20 + u}\t{'a b' if u % 2 else ''}" for u in range(35)]
    (tmp_path / "d.user").write_text("\n".join(users) + "\n")
    items = ["item_id:token\tvec:float_seq"]
    items += [f"i{i}\t{i} {i / 2}" for i in range(0, 55, 2)]
    (tmp_path / "d.item").write_text("\n".join(items) + "\n")


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == object:
            assert a.tolist() == b.tolist(), path
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


def test_load_atomic_dataset_matches_jax(tmp_path):
    _write(tmp_path)
    j = jatomic.load_atomic_dataset(str(tmp_path), "d")
    p = patomic.load_atomic_dataset(str(tmp_path), "d")
    for name in ("inter", "user", "item", "kg", "link"):
        _same(getattr(p, name), getattr(j, name), name)
    assert p.user_vocab == j.user_vocab and p.item_vocab == j.item_vocab
    assert (p.num_users, p.num_items) == (j.num_users, j.num_items)
    ji = j.to_interactions(rating_field="rating", time_field="timestamp")
    pi = p.to_interactions(rating_field="rating", time_field="timestamp")
    for attr in ("user_ids", "item_ids", "ratings", "timestamps"):
        _same(getattr(pi, attr), getattr(ji, attr), attr)
    jf = j.filter_interactions(min_rating=2.0, min_user_inter=3,
                               min_item_inter=2)
    pf = p.filter_interactions(min_rating=2.0, min_user_inter=3,
                               min_item_inter=2)
    for name in ("inter", "user", "item"):
        _same(getattr(pf, name), getattr(jf, name), name)
    assert pf.item_vocab == jf.item_vocab
    # no .kg file here: both raise (tests/test_torch_knowledge.py holds the
    # graph of one against JAX's)
    for ds in (j, p):
        with pytest.raises(ValueError, match="no .kg"):
            ds.to_knowledge_graph()


def test_column_helpers_match_jax():
    cols = {"r": np.array([1.0, 3.5, np.nan, 5.0], np.float32),
            "u": np.array(["a", "b", "a", "c"], dtype=object)}
    _same(patomic.filter_by_value(cols, {"r": (2.0, None)}),
          jatomic.filter_by_value(cols, {"r": (2.0, None)}))
    _same(patomic.label_by_threshold(cols, "r", 3.0),
          jatomic.label_by_threshold(cols, "r", 3.0))
    seeded = {"x": 7}
    pout, pvocab = patomic.remap_tokens([cols["u"], ["z", "a"]], seeded, 10)
    jout, jvocab = jatomic.remap_tokens([cols["u"], ["z", "a"]], seeded, 10)
    assert pvocab == jvocab
    for a, b in zip(pout, jout):
        np.testing.assert_array_equal(a, b)


def test_interaction_dataset_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.integers(0, 40, 500)
    i = rng.integers(100, 160, 500)
    r = rng.integers(1, 6, 500).astype(np.float32)
    t = rng.permutation(500).astype(np.float64)
    j, p = JInter(u, i, r, t), PInter(u, i, r, t)
    pairs = [(j.filter_by_count(5, 5), p.filter_by_count(5, 5)),
             (j.filter_by_rating(3.0), p.filter_by_rating(3.0)),
             (j.binarize(4.0), p.binarize(4.0)),
             (j.remap_ids(1), p.remap_ids(1))]
    pairs += list(zip(j.split_ratio(group_by_user=True, seed=3),
                      p.split_ratio(group_by_user=True, seed=3)))
    pairs += list(zip(j.split_ratio(order="TO"), p.split_ratio(order="TO")))
    pairs += list(zip(j.split_leave_one_out(), p.split_leave_one_out()))
    for a, b in pairs:
        _same(b.arrays(), a.arrays())
        assert b.user2items() == a.user2items()
    assert p.remap_ids(1).item_map == j.remap_ids(1).item_map
    with pytest.raises(ValueError, match="timestamps"):
        PInter(u, i).split_leave_one_out()
    with pytest.raises(ValueError):
        PInter(u, i[:3])


@pytest.mark.parametrize("name,gen", [("ctr", quality_exit.gen_ctr),
                                      ("seq", quality_exit.gen_seq)])
def test_exit_generators_write_the_jax_tools_files(tmp_path, name, gen):
    src = (ROOT / "tools" / f"parity_gen_{name}.py").read_text()
    jax_dir = tmp_path / "jax"
    subprocess.run([sys.executable, "-c",
                    src.replace("/tmp/parity", str(jax_dir))],
                   check=True, capture_output=True, timeout=120)
    data_dir = pathlib.Path(gen(str(tmp_path / "port")))
    (want,) = (jax_dir / f"synth{name}").iterdir()
    got = data_dir / want.name
    assert got.read_bytes() == want.read_bytes()
