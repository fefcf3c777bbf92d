"""`python -m recbox_tpu_torch.run` and its routes, the config copies and
`FeatureMap` persistence, against the JAX package, on the CPU.

- `run_expid` on the pre-encoded npz route (a sequential and a ranking
  expid: the same result keys as JAX's `run_expid`, the result line
  appended to ``<workdir>/results.jsonl``), the dataset-name route over a
  ``file://`` archive (as `tests/test_run_experiment.py:47` builds one)
  and the cascade route (as `tests/test_cascade_api.py:104`);
- overrides: dict / CLI > the dataset section > the expid > Base;
- the CLI in a subprocess prints one JSON line; a usage error exits 2; a
  stage the npz route cannot express raises;
- `grid_search_subprocess` launches ``-m recbox_tpu_torch.run``;
- a ``feature_map.json`` either package writes loads in the other, byte
  for byte;
- `HyperTuning` draws JAX's trials from the same seed.
"""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from recbox_tpu.config.hyper_tuning import HyperTuning as JHyperTuning
from recbox_tpu.features import FeatureMap as JFeatureMap
from recbox_tpu.features import FeatureSpec as JFeatureSpec
from recbox_tpu.run import run_expid as jrun_expid
from recbox_tpu_torch import run as prun
from recbox_tpu_torch.config import HyperTuning, grid_search_subprocess
from recbox_tpu_torch.data.acquire import register_dataset_url
from recbox_tpu_torch.features import FeatureMap, FeatureSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seq_data(data_dir, n_users=48, n_items=30, length=6, seed=0):
    """A pre-encoded sequential dataset: left-padded histories that follow
    next = cur + 1, leave-one-out targets."""
    rng = np.random.default_rng(seed)
    start = rng.integers(1, n_items + 1, n_users)
    full = (start[:, None] + np.arange(length + 3)[None, :] - 1) \
        % n_items + 1
    splits = {}
    for k, name in enumerate(("train", "valid", "test")):
        splits[name] = {"user_id": np.arange(n_users, dtype=np.int32),
                        "item_seq": full[:, k:k + length].astype(np.int32),
                        "seq_len": np.full(n_users, length, np.int32),
                        "item_id": full[:, k + length].astype(np.int32)}
    os.makedirs(data_dir, exist_ok=True)
    FeatureMap("seqds", (FeatureSpec("item_id", "categorical",
                                     source="item", vocab_size=n_items + 1,
                                     embedding_dim=8),),
               query_index="user_id", corpus_index="item_id",
               num_items=n_items + 1).save(
        os.path.join(data_dir, "feature_map.json"))
    for name, arrays in splits.items():
        np.savez(os.path.join(data_dir, f"{name}.npz"), **arrays)


def _ctr_data(data_dir, n=800, vocab=16, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, vocab, n).astype(np.int32)
    b = rng.integers(1, vocab, n).astype(np.int32)
    y = ((a % 2) ^ (b % 2)).astype(np.float32)
    os.makedirs(data_dir, exist_ok=True)
    FeatureMap("ctrds", (
        FeatureSpec("a", "categorical", vocab_size=vocab, embedding_dim=4),
        FeatureSpec("b", "categorical", vocab_size=vocab, embedding_dim=4)),
        labels=("click",)).save(os.path.join(data_dir, "feature_map.json"))
    cut = int(0.8 * n)
    np.savez(os.path.join(data_dir, "train.npz"), a=a[:cut], b=b[:cut],
             click=y[:cut])
    np.savez(os.path.join(data_dir, "valid.npz"), a=a[cut:], b=b[cut:],
             click=y[cut:])


@pytest.fixture(scope="module")
def expdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_run")
    _seq_data(str(root / "seq"))
    _ctr_data(str(root / "ctr"))
    cfg = root / "configs"
    cfg.mkdir()
    (cfg / "model_config.yaml").write_text(f"""
Base:
    epochs: 2
    learning_rate: 0.01
    device: cpu
    workdir: {root / "work"}
seq_sasrec:
    model: SASRec
    dataset_id: seqds
    embedding_dim: 8
    max_seq_len: 6
    n_layers: 1
    n_heads: 2
    dropout: 0.0
    batch_size: 16
    monitor: NDCG(k=10)
    topk: [5, 10]
ctr_deepfm:
    model: DeepFM
    dataset_id: ctrds
    hidden_units: [8]
    batch_size: 64
    monitor: AUC
seq_mf:
    model: MF
    dataset_id: seqds
""")
    (cfg / "dataset_config.yaml").write_text(f"""
seqds:
    data_dir: {root / "seq"}
    batch_size: 24
ctrds:
    data_dir: {root / "ctr"}
""")
    return root


def test_npz_routes_match_jax_keys_and_append_results(expdir):
    cfg = str(expdir / "configs")
    for expid in ("seq_sasrec", "ctr_deepfm"):
        got = prun.run_expid(cfg, expid)
        # JAX's run reads the same files (its own device, no `device` use)
        want = jrun_expid(cfg, expid)
        assert list(got) == list(want)
        assert got["experiment_id"] == expid
        assert all(np.isfinite(v) for k, v in got.items()
                   if isinstance(v, float))
    lines = (expdir / "work" / "results.jsonl").read_text().splitlines()
    assert [json.loads(ln)["experiment_id"] for ln in lines] == [
        "seq_sasrec", "seq_sasrec", "ctr_deepfm", "ctr_deepfm"]
    assert {"Recall(k=5)", "test_NDCG(k=10)"} <= set(json.loads(lines[0]))


def test_override_precedence(expdir):
    """The dataset section's batch_size (24) beats Base and the expid's
    (16); a dict override beats it; CLI-style values are typed."""
    from recbox_tpu_torch.config import load_config, parse_cli_overrides
    cfg = load_config(str(expdir / "configs"), "seq_sasrec")
    assert cfg["batch_size"] == 24 and cfg["epochs"] == 2
    cfg = load_config(str(expdir / "configs"), "seq_sasrec",
                      overrides=parse_cli_overrides(
                          ["--batch_size=8", "--topk=[3]", "--fused_ce=True",
                           "--device=cpu"]))
    assert cfg["batch_size"] == 8 and cfg["topk"] == [3]
    assert cfg["fused_ce"] is True and cfg["device"] == "cpu"


def test_wrong_stage_and_missing_data_raise(expdir, tmp_path):
    with pytest.raises(NotImplementedError, match="stage 'matching'"):
        prun.run_expid(str(expdir / "configs"), "seq_mf")
    (tmp_path / "model_config.yaml").write_text(
        "nodata:\n    model: SASRec\n")
    with pytest.raises(KeyError, match="data_dir"):
        prun.run_expid(str(tmp_path), "nodata")


def test_cli_prints_json_and_usage_exits_2(expdir):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "recbox_tpu_torch.run",
         f"--config={expdir / 'configs'}", "--expid=seq_sasrec",
         "--epochs=1", "--workdir=", "--device=cpu"],
        capture_output=True, text=True, env=env, timeout=240, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["model"] == "SASRec" and "test_Recall(k=10)" in result
    with pytest.raises(SystemExit) as err:
        prun.main(["--config=x"])
    assert err.value.code == 2


def test_autotuner_launches_the_port_cli(expdir, tmp_path):
    """`grid_search_subprocess` runs ``python -m recbox_tpu_torch.run`` per
    expid (CUDA_VISIBLE_DEVICES set), the two at once, each appending its
    result line to its own workdir (two runs in one workdir would both
    write its best.ckpt, in the reference too)."""
    work = tmp_path / "work"
    cfg = tmp_path / "cfg"
    cfg.mkdir()
    text = (expdir / "configs" / "model_config.yaml").read_text().replace(
        "epochs: 2", "epochs: 1")
    for expid in ("seq_sasrec", "ctr_deepfm"):
        text = text.replace(f"{expid}:\n",
                            f"{expid}:\n    workdir: {work / expid}\n")
    (cfg / "model_config.yaml").write_text(text)
    (cfg / "dataset_config.yaml").write_text(
        (expdir / "configs" / "dataset_config.yaml").read_text())
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO
    try:
        grid_search_subprocess(["seq_sasrec", "ctr_deepfm"],
                               config_dir=str(cfg), devices=("0", "1"),
                               poll_seconds=0.2)
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old
    for expid in ("seq_sasrec", "ctr_deepfm"):
        lines = (work / expid / "results.jsonl").read_text().splitlines()
        assert [json.loads(ln)["experiment_id"] for ln in lines] == [expid]


def _archive(tmp, name, n_users=40, n_items=24, seed=0):
    """A tiny atomic archive: each user's items walk next = cur + 1 in time
    (ratings 5), a few low ratings."""
    rng = np.random.default_rng(seed)
    lines = ["user_id:token\titem_id:token\trating:float\ttimestamp:float\n"]
    for u in range(n_users):
        start = int(rng.integers(0, n_items))
        for t in range(8):
            lines.append(f"u{u}\ti{(start + t) % n_items}\t"
                         f"{5.0 if t % 4 else 2.0}\t{t}.0\n")
    path = os.path.join(tmp, f"{name}.zip")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr(f"{name}/{name}.inter", "".join(lines))
    return path


@pytest.mark.parametrize("model,extra", [
    ("GRU4Rec", "max_seq_len: 6\n    hidden_size: 8\n    dropout: 0.0\n"
                "    monitor: NDCG(k=10)\n"),
    ("MF", "split: LS\n    num_negs: 2\n    monitor: Recall(k=20)\n"),
    ("DeepFM", "binarize_threshold: 4.0\n    hidden_units: [8]\n"),
    ("Pop", "split: LS\n"),
])
def test_dataset_name_route(tmp_path, model, extra):
    name = f"tiny-seq-{model.lower()}"
    register_dataset_url(name, f"file://{_archive(str(tmp_path), name)}")
    (tmp_path / "model_config.yaml").write_text(
        f"exp:\n    model: {model}\n    dataset: {name}\n"
        f"    dataset_dir: {tmp_path / 'data'}\n    epochs: 1\n"
        f"    embedding_dim: 8\n    batch_size: 32\n    device: cpu\n"
        f"    {extra}")
    out = prun.run_expid(str(tmp_path), "exp")
    assert out["dataset_id"] == name and out["model"] == model
    assert any(k.startswith("test_") for k in out), out


def test_cascade_route(tmp_path):
    from test_cascade_api import _gen_cascade_dataset
    root = str(tmp_path / "data")
    _gen_cascade_dataset(root, "casc_mini", users=80, items=60, per_user=16)
    (tmp_path / "model_config.yaml").write_text(
        "Base:\n  epochs: 1\ncasc:\n  model: cascade\n"
        "  dataset: casc_mini\n"
        f"  dataset_dir: {root}\n  matcher: MF\n  ranker: DeepFM\n"
        "  reranker: PRM\n  matcher_epochs: 1\n  ranker_epochs: 1\n"
        "  reranker_epochs: 1\n  candidates: 20\n  list_len: 5\n"
        "  embedding_dim: 8\n  batch_size: 128\n  topk_eval: [5]\n"
        "  device: cpu\n")
    out = prun.run_expid(str(tmp_path), "casc")
    assert out["model"] == "cascade" and out["dataset_id"] == "casc_mini"
    assert "stage3_NDCG@5" in out and "stage2_AUC" in out


def _feature_maps():
    specs = [dict(name="user_id", type="categorical", source="user",
                  vocab_size=100, embedding_dim=16),
             dict(name="hist", type="sequence", vocab_size=50,
                  embedding_dim=8, max_len=5, share_embedding="item_id",
                  padding_idx=2, pooling="sum", shard_table=False),
             dict(name="price", type="numeric", embedding_dim=4),
             dict(name="gid", type="meta")]
    kw = dict(labels=("click", "buy"), query_index="user_id",
              corpus_index="item_id", group_id="gid", num_items=51,
              num_samples=12345)
    return (JFeatureMap("ds", tuple(JFeatureSpec(**s) for s in specs), **kw),
            FeatureMap("ds", tuple(FeatureSpec(**s) for s in specs), **kw))


def test_feature_map_json_round_trips_with_jax(tmp_path):
    jfm, pfm = _feature_maps()
    assert pfm.to_json() == jfm.to_json()
    jfm.save(str(tmp_path / "j" / "feature_map.json"))
    loaded = FeatureMap.load(str(tmp_path / "j" / "feature_map.json"))
    assert loaded == pfm and loaded.to_json() == jfm.to_json()
    pfm.save(str(tmp_path / "p" / "feature_map.json"))
    assert (tmp_path / "p" / "feature_map.json").read_bytes() == \
        (tmp_path / "j" / "feature_map.json").read_bytes()
    assert JFeatureMap.load(str(tmp_path / "p" / "feature_map.json")) == jfm
    assert pfm.num_fields == jfm.num_fields == 3
    assert pfm.sum_emb_out_dim() == jfm.sum_emb_out_dim()
    assert [f.name for f in pfm.by_type("sequence")] == ["hist"]
    assert pfm.replace(num_items=7).num_items == 7
    # a pretrained, frozen table's fields persist as JAX's
    spec = dict(name="x", type="categorical", vocab_size=5, embedding_dim=4,
                pretrain_path="emb.npy", freeze_emb=True)
    assert FeatureSpec(**spec).to_dict() == JFeatureSpec(**spec).to_dict()


@pytest.mark.parametrize("algo", ["random", "bayes", "exhaustive"])
def test_hyper_tuning_draws_jax_trials(algo):
    space = {"lr": ("loguniform", 1e-4, 1e-1), "drop": ("uniform", 0.0, 0.5),
             "dim": ("choice", [8, 16, 32]), "reg": ("quniform", 0, 1, 0.25)}
    if algo == "exhaustive":
        space = {"dim": ("choice", [8, 16, 32]), "act": ("choice", ["a", "b"])}

    def objective(p):
        return {"metric": -sum(float(hash(str(v)) % 97) for v in p.values())
                if algo == "exhaustive" else
                -(np.log10(p["lr"]) + 2.5) ** 2 - p["drop"] + p["dim"] / 64
                - p["reg"]}

    runs = []
    for cls in (JHyperTuning, HyperTuning):
        ht = cls(objective, space, algo=algo, max_evals=14, early_stop=6,
                 seed=3)
        runs.append((ht.run(), [t["params"] for t in ht.trials]))
    assert runs[0] == runs[1]
    assert len(runs[1][1]) >= 6
