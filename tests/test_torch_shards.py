"""The port's shard IO and streaming loader (`recbox_tpu_torch/data/
shards.py`, `native_shards.py`) against the JAX package's, on the CPU.

Mirrors `tests/test_shards.py` and the shard cases of
`tests/test_native_fixes.py` on the port's functions, and adds the paired
cases: shard directories written by either package read by the other under
both reader backends, and `ShardLoader` batches equal to JAX's at the same
seed, bit for bit.
"""

import gc
import json
import threading
import time

import numpy as np
import pytest
import torch

from recbox_tpu.data.shards import ShardLoader as JShardLoader
from recbox_tpu.data.shards import save_shards as jsave_shards
from recbox_tpu_torch.data import ShardLoader, load_shards, save_shards
from recbox_tpu_torch.data.native_shards import (
    NativeShardStream, native_reader_available,
)
from recbox_tpu_torch.data.shards import shard_meta


def _arrays(rng, n=1000):
    return {"a": rng.integers(0, 50, n).astype(np.int32),
            "x": rng.normal(size=(n, 3)).astype(np.float32),
            "y": (rng.random(n) > 0.5).astype(np.float32)}


def _batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def test_save_load_roundtrip(rng, tmp_path):
    arrays = _arrays(rng)
    files = save_shards(str(tmp_path), arrays, rows_per_shard=300)
    assert len(files) == 4
    meta = shard_meta(str(tmp_path))
    assert meta["num_samples"] == 1000
    assert meta["columns"]["x"]["shape"] == [3]
    back = load_shards(str(tmp_path))
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], back[k])


def test_loader_covers_every_row_once_with_static_shapes(rng, tmp_path):
    arrays = _arrays(rng, n=1001)
    save_shards(str(tmp_path), arrays, rows_per_shard=300)
    loader = ShardLoader(str(tmp_path), batch_size=128, shuffle=True, seed=0)
    assert loader.num_samples == 1001
    assert len(loader) == 8
    seen = []
    for batch in loader:
        assert batch["a"].shape == (128,)
        assert batch["x"].shape == (128, 3)
        mask = batch.pop("__mask__").astype(bool)
        seen.append(batch["a"][mask])
    got = np.sort(np.concatenate(seen))
    np.testing.assert_array_equal(got, np.sort(arrays["a"]))


def test_loader_drop_last_and_cross_shard_carry(rng, tmp_path):
    arrays = _arrays(rng, n=950)
    save_shards(str(tmp_path), arrays, rows_per_shard=300)  # 300*3 + 50
    loader = ShardLoader(str(tmp_path), batch_size=256, shuffle=False,
                         drop_last=True)
    batches = list(loader)
    assert len(batches) == 3
    flat = np.concatenate([b["a"] for b in batches])
    np.testing.assert_array_equal(flat, arrays["a"][:768])


def test_loader_epoch_reshuffles(rng, tmp_path):
    arrays = _arrays(rng, n=600)
    save_shards(str(tmp_path), arrays, rows_per_shard=200)
    loader = ShardLoader(str(tmp_path), batch_size=100, seed=3)
    e1 = np.concatenate([b["a"] for b in loader])
    e2 = np.concatenate([b["a"] for b in loader])
    assert not np.array_equal(e1, e2)
    np.testing.assert_array_equal(np.sort(e1), np.sort(e2))


def test_multi_reader_partition(rng, tmp_path):
    arrays = _arrays(rng, n=900)
    save_shards(str(tmp_path), arrays, rows_per_shard=300)
    parts = []
    for i in range(3):
        loader = ShardLoader(str(tmp_path), batch_size=100, shuffle=False,
                             shard_index=i, num_shard_readers=3)
        assert loader.num_samples == 300
        parts.append(np.concatenate(
            [b["a"][b["__mask__"].astype(bool)] for b in loader]))
    got = np.sort(np.concatenate(parts))
    np.testing.assert_array_equal(got, np.sort(arrays["a"]))


def test_loader_feeds_trainer_fit(rng, tmp_path):
    from recbox_tpu_torch.evaluation import CTREvaluator
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.ranking import DeepFM
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.training import Trainer, TrainerConfig

    n = 2000
    a = rng.integers(1, 40, n).astype(np.int32)
    y = (a % 2).astype(np.float32)
    save_shards(str(tmp_path), {"a": a, "click": y}, rows_per_shard=512)
    fm = FeatureMap("sh", (
        FeatureSpec("a", "categorical", vocab_size=40, embedding_dim=8),),
        labels=("click",))
    tr = Trainer(DeepFM(fm, embedding_dim=8, hidden_units=(16,),
                        generator=torch.Generator().manual_seed(0),
                        device="cpu"),
                 lambda o, b: binary_crossentropy(o, b["click"]),
                 TrainerConfig(learning_rate=1e-2, epochs=4, patience=6,
                               monitor="AUC", lr_decay_factor=1.0,
                               reload_best_on_plateau=False),
                 eval_fn=CTREvaluator({"a": a[:300], "click": y[:300]},
                                      label="click", metrics=["AUC"]),
                 device="cpu")
    loader = ShardLoader(str(tmp_path), batch_size=256, drop_last=True,
                         seed=1)
    metrics = tr.fit(loader)
    assert metrics["AUC"] > 0.95, metrics


def test_save_shards_removes_stale_parts(rng, tmp_path):
    save_shards(str(tmp_path), _arrays(rng, n=1000), rows_per_shard=100)
    save_shards(str(tmp_path), _arrays(rng, n=250), rows_per_shard=100)
    back = load_shards(str(tmp_path))
    assert len(back["a"]) == 250
    loader = ShardLoader(str(tmp_path), batch_size=100, shuffle=False)
    assert sum(int(b["__mask__"].sum()) for b in loader) == 250


def test_multi_reader_counts_from_meta_with_uneven_tail(rng, tmp_path):
    arrays = _arrays(rng, n=950)                 # shards: 300,300,300,50
    save_shards(str(tmp_path), arrays, rows_per_shard=300)
    counts = []
    for i in range(3):
        loader = ShardLoader(str(tmp_path), batch_size=64, shuffle=False,
                             shard_index=i, num_shard_readers=3)
        got = sum(int(b["__mask__"].sum()) for b in loader)
        assert got == loader.num_samples, (i, got, loader.num_samples)
        counts.append(got)
    assert sum(counts) == 950


def test_abandoned_iterator_does_not_block_producer(rng, tmp_path):
    save_shards(str(tmp_path), _arrays(rng, n=3000), rows_per_shard=200)
    loader = ShardLoader(str(tmp_path), batch_size=100, prefetch=1,
                         reader_backend="numpy")
    before = threading.active_count()
    for _ in range(5):
        it = iter(loader)
        next(it)                      # peek one batch, then abandon
        del it
        gc.collect()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, (
        "producer threads leaked after abandoned iteration")


def test_producer_error_surfaces_in_consumer(rng, tmp_path):
    save_shards(str(tmp_path), _arrays(rng, n=600), rows_per_shard=200)
    (tmp_path / "part-00001.npz").write_bytes(b"not a zip file at all")
    loader = ShardLoader(str(tmp_path), batch_size=100, shuffle=False,
                         reader_backend="numpy")
    with pytest.raises(Exception):
        list(loader)


def test_peek_batch_pads_a_short_first_shard(rng, tmp_path):
    arrays = _arrays(rng, n=90)
    save_shards(str(tmp_path), arrays, rows_per_shard=60)
    peek = ShardLoader(str(tmp_path), batch_size=100).peek_batch()
    want = JShardLoader(str(tmp_path), batch_size=100).peek_batch()
    _batches_equal([peek], [want])
    assert peek["a"].shape == (100,) and peek["__mask__"].sum() == 100
    np.testing.assert_array_equal(peek["a"][60:], arrays["a"][59])


def test_rejects_bad_backend_and_empty_dir(tmp_path):
    with pytest.raises(ValueError, match="reader_backend"):
        ShardLoader(str(tmp_path), reader_backend="mmap")
    with pytest.raises(FileNotFoundError):
        ShardLoader(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_shards(str(tmp_path))


def test_ragged_columns_rejected(tmp_path):
    with pytest.raises(ValueError, match="ragged"):
        save_shards(str(tmp_path), {"a": np.zeros(3), "b": np.zeros(4)})


# -- files and batches against JAX's --------------------------------------------

def test_files_equal_jax_bytes(rng, tmp_path):
    """The same arrays written by both packages: meta.json byte for byte,
    and parts that decode to the same members."""
    arrays = _arrays(rng, n=700)
    pfiles = save_shards(str(tmp_path / "p"), arrays, rows_per_shard=256)
    jfiles = jsave_shards(str(tmp_path / "j"), arrays, rows_per_shard=256)
    assert [f.split("/")[-1] for f in pfiles] \
        == [f.split("/")[-1] for f in jfiles]
    assert (tmp_path / "p" / "meta.json").read_bytes() \
        == (tmp_path / "j" / "meta.json").read_bytes()
    for pf, jf in zip(pfiles, jfiles):
        _batches_equal([dict(np.load(pf))], [dict(np.load(jf))])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True)])
def test_loader_batches_equal_jax(rng, tmp_path, writer, backend, shuffle,
                                  drop_last):
    """Either package's shards, read by both packages' loaders at one seed
    (two epochs, the second reshuffled): the same batches bit for bit."""
    arrays = _arrays(rng, n=1001)
    (jsave_shards if writer == "jax" else save_shards)(
        str(tmp_path), arrays, rows_per_shard=300)
    kw = dict(batch_size=128, shuffle=shuffle, drop_last=drop_last, seed=7,
              reader_backend=backend)
    p, j = ShardLoader(str(tmp_path), **kw), JShardLoader(str(tmp_path), **kw)
    assert len(p) == len(j) and p.num_samples == j.num_samples
    for _ in range(2):
        _batches_equal(list(p), list(j))


@pytest.mark.parametrize("index", [0, 1, 2])
def test_multi_reader_partition_equals_jax(rng, tmp_path, index):
    jsave_shards(str(tmp_path), _arrays(rng, n=950), rows_per_shard=300)
    kw = dict(batch_size=64, seed=2, shard_index=index, num_shard_readers=3)
    p, j = ShardLoader(str(tmp_path), **kw), JShardLoader(str(tmp_path), **kw)
    assert p.num_samples == j.num_samples and len(p) == len(j)
    _batches_equal(list(p), list(j))


class TestNativeShardReader:
    """The C++ decoder pool (`native/shard_reader.cpp`, the port's build)
    == the numpy path, bit for bit."""

    def test_available(self):
        assert native_reader_available()

    def test_stream_decodes_identically(self, tmp_path):
        rng = np.random.default_rng(0)
        arrays = {
            "f32": rng.normal(size=(700, 3)).astype(np.float32),
            "i64": rng.integers(0, 9, 700).astype(np.int64),
            "i32": rng.integers(0, 9, (700, 2)).astype(np.int32),
            "f64": rng.normal(size=700),
            "b": (rng.random(700) > 0.5),
        }
        files = save_shards(str(tmp_path), arrays, rows_per_shard=256)
        parts = list(NativeShardStream(files, prefetch=2, n_threads=3))
        assert len(parts) == len(files)
        _batches_equal(parts, [dict(np.load(f)) for f in files])

    def test_loader_backends_bitwise_equal(self, tmp_path):
        rng = np.random.default_rng(1)
        save_shards(str(tmp_path),
                    {"x": rng.normal(size=(1000, 4)).astype(np.float32),
                     "y": rng.integers(0, 5, 1000).astype(np.int32)},
                    rows_per_shard=300)

        def batches(backend):
            return list(ShardLoader(str(tmp_path), batch_size=128, seed=7,
                                    reader_backend=backend))

        _batches_equal(batches("native"), batches("numpy"))

    def test_error_surfaces(self, tmp_path):
        bad = tmp_path / "part-000.npz"
        bad.write_bytes(b"not a zip file at all")
        with pytest.raises(IOError, match="native shard reader"):
            list(NativeShardStream([str(bad)]))

    def test_truncated_shard_surfaces_error(self, tmp_path):
        good = tmp_path / "good.npz"
        np.savez(str(good), a=np.arange(8, dtype=np.float32))
        raw = good.read_bytes()
        bad = tmp_path / "bad.npz"
        bad.write_bytes(raw[: len(raw) // 3])       # truncated partial write
        with pytest.raises(Exception):
            for _ in NativeShardStream([str(bad)], prefetch=1):
                pass

    def test_roundtrips_scalar_members(self, tmp_path):
        path = tmp_path / "s.npz"
        np.savez(str(path), rows=np.arange(6, dtype=np.int64),
                 n_rows=np.int64(1234))
        (part,) = list(NativeShardStream([str(path)], prefetch=1))
        ref = np.load(str(path))
        assert part["n_rows"].shape == ref["n_rows"].shape == ()
        assert int(part["n_rows"]) == 1234
        np.testing.assert_array_equal(part["rows"], ref["rows"])

    def test_abandoned_native_iterator_closes(self, rng, tmp_path):
        save_shards(str(tmp_path), _arrays(rng, n=3000), rows_per_shard=200)
        loader = ShardLoader(str(tmp_path), batch_size=100, prefetch=1,
                             reader_backend="native")
        for _ in range(3):
            it = iter(loader)
            next(it)
            it.close()
        assert sum(int(b["__mask__"].sum()) for b in loader) == 3000

    def test_meta_is_json_of_the_arrays(self, rng, tmp_path):
        arrays = _arrays(rng, n=10)
        save_shards(str(tmp_path), arrays, rows_per_shard=4)
        meta = json.loads((tmp_path / "meta.json").read_text())
        assert meta == {"num_samples": 10, "rows_per_shard": 4,
                        "num_shards": 3,
                        "columns": {"a": {"dtype": "int32", "shape": []},
                                    "x": {"dtype": "float32", "shape": [3]},
                                    "y": {"dtype": "float32", "shape": []}}}
