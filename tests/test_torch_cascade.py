"""The port's one-call cascade, `run_cascade_experiment`, on the CPU.

* The toy dataset of `tests/test_cascade_api.py:27` at that file's knobs,
  held to its thresholds (:68-101); its `run.py` route (:104) waits for
  `ROADMAP.md` Queue A's "Orchestration remainder".
* A paired run: the port's three models start from the JAX run's initial
  params (recorded from JAX's `Trainer.init`, in the order the stages
  build them), and the whole result equals JAX's on a dataset where every
  user's unseen pool is smaller than ``candidates`` and some users have no
  valid items, hence no hard pool: the two behaviours `ADVICE.md:3-4`
  records (−inf-scored seen items in a short candidate list; the
  hard-negative fallback not resampling seen items), which the port
  keeps, are on the path. Metrics atol 1e-5 (the MF / DCN / PRM steps
  agree to ~1e-6; the metrics are means of ranks of their scores).
* The two behaviours shown directly on the port's helpers.
* `data/acquire.py`'s copy over `file://` archives only (as
  `tests/test_acquire.py` runs JAX's): the cache short-circuit, a missing
  url, download + extraction + renaming, a checksum mismatch.
"""

import hashlib
import os
import zipfile

import numpy as np
import pytest

from recbox_tpu.quick_start import run_cascade_experiment as jrun
from recbox_tpu_torch import quick_start as qs
from recbox_tpu_torch.data.acquire import (
    DATASET_URLS, acquire_dataset, register_dataset_url,
)
from tests.test_cascade_api import _gen_cascade_dataset
from tests.test_torch_reranking import load_inits, record_jax_inits


@pytest.fixture(scope="module")
def cascade_result(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cascade"))
    _gen_cascade_dataset(root, "casc_synth")
    timings = {}
    result = qs.run_cascade_experiment(
        "casc_synth", data_dir=root, order="RO",
        matcher_epochs=4, ranker_epochs=2, reranker_epochs=3,
        candidates=50, list_len=10, embedding_dim=16,
        batch_size=256, topk_eval=(5, 10), device="cpu", timings=timings)
    return result, timings


def test_toy_cascade_meets_the_jax_tests_thresholds(cascade_result):
    """`tests/test_cascade_api.py`'s thresholds (JAX measured there, at
    seed 2024: candidate recall .850, stage 1 .669 / .721, AUC .7365)."""
    r, timings = cascade_result
    assert r["candidate_recall"] > 0.6
    assert r["stage1_Recall(k=20)"] > 0.4
    assert r["stage1_test_Recall(k=20)"] > 0.4
    assert r["stage2_AUC"] > 0.62
    assert r["stage2_logloss"] < 0.69
    assert r["stage3_NDCG@5"] > r["list_ranker_NDCG@5"] + 0.005
    assert r["stage3_NDCG@10"] >= r["list_ranker_NDCG@10"] - 0.005
    assert r["list_ranker_NDCG@5"] >= r["list_matcher_NDCG@5"] - 0.01
    assert {"candidate_recall", "stage2_AUC", "stage2_logloss",
            "matcher_order_NDCG@5", "ranker_order_NDCG@10",
            "list_matcher_NDCG@5", "list_ranker_NDCG@10",
            "stage3_NDCG@5", "stage3_MAP@10"} <= set(r)
    assert set(timings) == {"data_s", "stage1_s", "stage2_s", "stage3_s"}
    assert all(t > 0 for t in timings.values())


def _gen_short_pools(root, name, users=50, items=40, seed=0):
    """Users 0..41 rate 16 items (the unseen pool of a test list: under
    ~27 of 39), users 42..49 rate 4 (no valid item at 0.8 / 0.1 / 0.1, so
    no hard pool)."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(users):
        k = 16 if u < 42 else 4
        pref = (u % 4) * 10
        block = pref + rng.choice(10, size=min(k, 8), replace=False)
        rest = rng.choice(np.setdiff1d(np.arange(items), block),
                          size=k - len(block), replace=False)
        for t, it in enumerate(np.concatenate([block, rest])):
            rows.append((u, it, 1, t))
    rng.shuffle(rows)
    folder = os.path.join(root, name)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, f"{name}.inter"), "w") as fh:
        fh.write("user_id:token\titem_id:token\trating:float\t"
                 "timestamp:float\n")
        for u, i, r, t in rows:
            fh.write(f"{u}\t{i}\t{r}\t{t}\n")


def test_cascade_paired_with_jax_equals_its_result(tmp_path, monkeypatch):
    root = str(tmp_path)
    _gen_short_pools(root, "casc_short")
    kw = dict(data_dir=root, order="RO", matcher_epochs=2, ranker_epochs=2,
              reranker_epochs=2, candidates=30, list_len=8,
              embedding_dim=8, batch_size=64, topk_eval=(3, 5),
              num_cross_layers=2, hidden_units=[8], n_heads=2, n_layers=1,
              d_model=8)
    with record_jax_inits(monkeypatch) as inits:
        want = jrun("casc_short", **kw)
    assert len(inits) == 3                # matcher, ranker, reranker
    queue = load_inits(monkeypatch, inits)
    got = qs.run_cascade_experiment("casc_short", device="cpu", **kw)
    assert not queue
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_short_candidate_lists_take_seen_items_scored_minus_inf():
    """`ADVICE.md:3`: with 4 unseen items and k = 6, two slots hold seen
    items, after every unseen one."""
    rng = np.random.default_rng(0)
    user_embs = rng.normal(size=(2, 3))
    item_embs = rng.normal(size=(8, 3))
    seen = {0: [1, 2, 3], 1: [4]}
    cand = qs._candidate_lists(user_embs, item_embs, np.array([0, 1]),
                               (seen,), 6, exclude=(0,))
    unseen0 = {4, 5, 6, 7}
    assert set(cand[0][:4]) == unseen0
    assert set(cand[0][4:]) <= {0, 1, 2, 3}
    scores = user_embs[0] @ item_embs.T
    assert list(cand[0][:4]) == sorted(unseen0, key=lambda i: -scores[i])
    assert not set(cand[1]) & {0, 4}


def test_hard_negative_fallback_keeps_seen_items():
    """`ADVICE.md:4`: a user without a hard pool gets uniform items as its
    hard negatives, seen ones included; the uniform negatives are drawn
    again where they hit a seen item."""
    class Split:
        user_ids = np.zeros(400, np.int64)
        item_ids = np.arange(400) % 9 + 1

    seen = {0: list(range(1, 10))}                  # 9 of 10 items seen
    u, i, y = qs._ctr_rows(Split, (seen,), np.random.default_rng(0), 10,
                           neg_per_pos=2, exclude=(0,), hard_pool={})
    assert (y == 1).sum() == 400 and (y == 0).sum() == 800
    negs = i[y == 0]
    # one uniform and one fallback negative a positive: the fallback
    # draws land on seen items 9 times in 10
    assert np.mean(np.isin(negs, range(1, 10))) > 0.4
    pool = {0: np.array([7])}
    u, i, y = qs._ctr_rows(Split, (seen,), np.random.default_rng(0), 10,
                           neg_per_pos=2, exclude=(0,), hard_pool=pool)
    assert (i[y == 0] == 7).sum() >= 400


def test_cascade_refuses_wrong_stages_and_unported_pipelines(tmp_path):
    root = str(tmp_path)
    _gen_cascade_dataset(root, "casc_err", users=60, items=40, per_user=12)
    with pytest.raises(ValueError, match="stage"):
        qs.run_cascade_experiment("casc_err", data_dir=root,
                                  matcher="DeepFM", device="cpu")
    for fn in (qs.run_experiment, qs.run_matching_experiment,
               qs.run_sequential_experiment, qs.run_kg_experiment):
        with pytest.raises(NotImplementedError,
                           match="Orchestration remainder"):
            fn("MF", "casc_err")


def _zip(tmp_path, inner, base):
    src = tmp_path / "src"
    src.mkdir(exist_ok=True)
    archive = src / f"{base}.zip"
    with zipfile.ZipFile(archive, "w") as zf:
        zf.writestr(f"{inner}/{base}.inter",
                    "user_id:token\titem_id:token\n1\t2\n")
    return archive


def test_acquire_over_file_urls(tmp_path):
    d = tmp_path / "data" / "staged"
    d.mkdir(parents=True)
    (d / "staged.inter").write_text("user_id:token\n1\n")
    assert acquire_dataset("staged", str(tmp_path / "data")) == str(d)
    with pytest.raises(KeyError, match="no download url"):
        acquire_dataset("nowhere", str(tmp_path / "data"))
    archive = _zip(tmp_path, "Inner", "arch")
    register_dataset_url("fetched", "file://" + str(archive))
    folder = acquire_dataset("fetched", str(tmp_path / "data"))
    assert os.path.exists(os.path.join(folder, "fetched.inter"))
    digest = hashlib.sha256(archive.read_bytes()).hexdigest()
    folder = acquire_dataset("pinned", str(tmp_path / "d2"),
                             url="file://" + str(archive), checksum=digest)
    assert os.path.exists(os.path.join(folder, "pinned.inter"))
    with pytest.raises(IOError, match="checksum mismatch"):
        acquire_dataset("bad", str(tmp_path / "d3"),
                        url="file://" + str(archive), checksum="0" * 64)
    assert "ml-1m" in DATASET_URLS and "gowalla" in DATASET_URLS
