"""Two ranks of the port: the rank-0 checkpoint, the metric merge, the
trainer's merged evaluation, `shard_batch`, the rank-0 dataset download
and `OrbaxCheckpointer`.

Mirrors `tests/test_multihost.py`, whose two processes rendezvous through
`jax.distributed`; here two gloo processes meet through a ``file://``
store (`torch_parallel_workers.multihost`).
"""

import os
import zipfile

import pytest

import torch_parallel_workers as W


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    data_dir = tmp / "data"
    folder = data_dir / "mhds"
    folder.mkdir(parents=True)
    # the archive is staged where `download_url` finds it cached: no fetch
    with zipfile.ZipFile(folder / "mhds.zip", "w") as zf:
        zf.writestr("inner/raw.inter", "user_id:token\titem_id:token\n1\t2\n")
    res = W.run("multihost", 2, tmp, ckpt=str(tmp / "mh.ckpt"),
                data_dir=str(data_dir), orbax_dir=str(tmp / "orbax"))
    return tmp, res


def test_only_rank0_writes_the_checkpoint(ranks):
    tmp, res = ranks
    for r in res:
        assert int(r["process_count"]) == 2
        assert not bool(r["rank1_wrote"])
        assert int(r["writer"]) == 0
        assert not bool(r["tmp_left"])
    assert (tmp / "mh.ckpt").exists() and not (tmp / "mh.ckpt.tmp").exists()


@pytest.mark.parametrize("key,want", [
    ("merged", 0.25),                      # (1·1 + 0·3) / 4
    ("merged_empty", 0.5),                 # the empty rank adds zeros
    ("trainer_merged", (0.9 * 2 + 0.5 * 6) / 8),
    ("unweighted", (0.9 + 0.5) / 2),       # no last_sample_count: 1 each
])
def test_metric_merges(ranks, key, want):
    for r in ranks[1]:
        assert abs(float(r[key]) - want) < 1e-9, (key, r[key])


def test_missing_sample_count_warns(ranks):
    assert all(bool(r["warned"]) for r in ranks[1])


def test_shard_batch_assembles_the_global_batch(ranks):
    """2 ranks x 4 local rows: one 8-row global batch holding both."""
    for r in ranks[1]:
        assert int(r["global_rows"]) == 8
        assert abs(float(r["global_sum"]) - (6.0 + 46.0)) < 1e-6


def test_acquire_rank0_extracts_rank1_waits(ranks):
    tmp, res = ranks
    assert all(bool(r["inter_seen"]) for r in res)
    assert (tmp / "data" / "mhds" / "mhds.inter").exists()


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_orbax_checkpointer_round_trip(ranks, kind):
    """save (each rank its shards, asynchronously) → a step meanwhile →
    wait (the meta committed) → load into a fresh trainer → one step: the
    state equals the trainer that never stopped."""
    tmp, res = ranks
    for r in res:
        assert bool(r[f"orbax_{kind}_meta"])
        assert int(r[f"orbax_{kind}_step"]) == 2
        assert bool(r[f"orbax_{kind}_equal"])
    assert os.path.isdir(tmp / "orbax" / kind)


def test_chip_smoke_5r_two_rank_rehearsal():
    """`chip_smoke.py` phase 5r(b) on the CPU at a small width: the same
    two gloo ranks (`gloo_pair`), the packed and the generic DeepFM
    trainers against their unsharded runs, the counted bytes against the
    model, the sharded search against the exact one (and 5v(c)'s past
    k = 8192: 2 x 20,000 rows at k = 9,000), and the phase's own check
    (`check_two_ranks`; the plain versions count no launches)."""
    import importlib
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    cs = importlib.import_module("chip_smoke")
    width = dict(NUM_CAT=4, NUM_NUM=2, VOCAB=500, DIM=8, HIDDEN=(16,),
                 R_ITEMS=5003, R_D=16, R_Q=37, R_K=20, R_GLOO_BATCH=64,
                 V_SHARD=20_000, V_K=9000, V_SEARCH_Q=8)
    res = cs.mesh_two_ranks(device="cpu", width=width)
    assert cs.check_two_ranks(res, on_card=False)
    r0 = res["ranks"][0]
    assert r0["packed"]["loss_max_rel_err"] <= 1e-5
    assert r0["search"]["ids_equal_but_ties"]
    assert r0["search"]["max_abs_err"] == 0.0
    assert r0["search_large_k"]["ids_equal_but_ties"]
