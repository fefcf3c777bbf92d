"""One-call experiment pipelines: the ranking, reranking and cascade ones.

Counterpart of `recbox_tpu/quick_start.py`: `build_model` (:84),
`build_trainer_config` (:95), `run_ranking_experiment` (:101, with
``trainer: packed`` → `PackedEmbeddingTrainer`, :135-142),
`run_rerank_experiment` (:389), `_user2items`, `_acquire_interactions` and
`_filter_and_remap` (:603-645) and `run_cascade_experiment` (:886-1213).
A model's hyperparameters come from the config by the names of its
constructor's arguments (JAX's: its dataclass fields); its initial draw
from a generator seeded with the config's ``seed`` (2024 by default; JAX
draws it from ``TrainerConfig.seed``, the same key). Every entry point
takes ``device=`` and runs on the CUDA device unless the caller names
another (`recbox_tpu_torch.resolve_device`, which raises without a card).

`run_matching_experiment`, `run_sequential_experiment`,
`run_kg_experiment` and `run_experiment` are not ported yet: they raise,
naming `ROADMAP.md` Queue A's "Orchestration remainder"; so do the
multitask branch of `run_ranking_experiment` ("Ranking zoo remainder").

`run_cascade_experiment` keeps two behaviours of the reference that
`ADVICE.md:3-4` records as defects, so that both packages compute the same
cascade (see its docstring).
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.config.config import Config
from recbox_tpu_torch.data import ArrayLoader, MatchingLoader
from recbox_tpu_torch.evaluation.evaluators import (
    CTREvaluator, RetrievalEvaluator,
)
from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.registry import get_model
from recbox_tpu_torch.ops.losses import binary_crossentropy, get_matching_loss
from recbox_tpu_torch.training import Trainer, TrainerConfig

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["build_model", "build_reranker", "build_trainer_config",
           "run_ranking_experiment", "run_matching_experiment",
           "run_sequential_experiment", "run_rerank_experiment",
           "run_kg_experiment", "run_experiment", "run_cascade_experiment"]

Device = Optional[Union[str, torch.device]]
_ORCHESTRATION = "(ROADMAP.md, Queue A: \"Orchestration remainder\")"


def _model_kwargs(cls, config: Mapping[str, Any]) -> Dict[str, Any]:
    """The config's entries that name arguments of ``cls``'s constructor
    (lists as tuples), as JAX's picks its dataclass fields."""
    names = set(inspect.signature(cls.__init__).parameters) - {
        "self", "feature_map", "generator", "device", "in_dim"}
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in config.items() if k in names}


def _generator(config: Mapping[str, Any], device: torch.device
               ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        int(config.get("seed", 2024)))


def build_model(config: Mapping[str, Any], feature_map: FeatureMap,
                device: Device = None):
    """(model, stage): the configured model, given the config keys that
    match its constructor's arguments (embedding_dim, hidden_units, ...),
    drawn from a generator seeded with the config's ``seed``."""
    cls, stage = get_model(config["model"])
    dev = resolve_device(device)
    return cls(feature_map, **_model_kwargs(cls, config),
               generator=_generator(config, dev), device=dev), stage


def build_reranker(config: Mapping[str, Any], in_dim: int,
                   device: Device = None) -> torch.nn.Module:
    """The configured listwise reranker over ``in_dim``-wide slot features
    (JAX's infers the width at init), drawn as `build_model` draws."""
    cls, stage = get_model(config["model"])
    if stage != "reranking":
        raise ValueError(f"{config['model']} is not a reranker")
    dev = resolve_device(device)
    return cls(in_dim, **_model_kwargs(cls, config),
               generator=_generator(config, dev), device=dev)


def build_trainer_config(config: Mapping[str, Any]) -> TrainerConfig:
    import dataclasses
    names = {f.name for f in dataclasses.fields(TrainerConfig)}
    return TrainerConfig(**{k: v for k, v in config.items() if k in names})


def run_ranking_experiment(
    config: Mapping[str, Any],
    feature_map: FeatureMap,
    train_arrays: Dict[str, np.ndarray],
    valid_arrays: Dict[str, np.ndarray],
    test_arrays: Optional[Dict[str, np.ndarray]] = None,
    mesh=None,
    device: Device = None,
) -> Dict[str, float]:
    """CTR pipeline: loader → model → trainer.fit → metrics (valid, and
    ``test_*`` with ``test_arrays``). ``trainer: packed`` in the config
    trains the tables with `PackedEmbeddingTrainer` (one row gather and
    one B1 update a step)."""
    config = Config(config)
    dev = resolve_device(device)
    model, stage = build_model(config, feature_map, dev)
    if stage == "multitask":
        raise NotImplementedError(
            "the multitask branch is not ported yet (ROADMAP.md, Queue A: "
            "\"Ranking zoo remainder\")")
    batch_size = config.get("batch_size", 2048)
    label = list(feature_map.labels)[0]
    metrics = list(config.get("metrics", ["AUC", "logloss"]))
    group_id = config.get("group_id") or None
    evaluator = CTREvaluator(valid_arrays, label=label, metrics=metrics,
                             group_id=group_id)

    def loss_fn(outputs, batch):
        return binary_crossentropy(outputs, batch[label])

    if config.get("trainer", "dense") == "packed":
        from recbox_tpu_torch.training.packed import PackedEmbeddingTrainer
        trainer = PackedEmbeddingTrainer(
            model, loss_fn, build_trainer_config(config), eval_fn=evaluator,
            mesh=mesh, device=dev,
            embedding_optimizer=config.get("embedding_optimizer", "adagrad"),
            embedding_lr=config.get("embedding_lr"))
    else:
        trainer = Trainer(model, loss_fn, build_trainer_config(config),
                          eval_fn=evaluator, mesh=mesh, device=dev)
    loader = ArrayLoader(train_arrays, batch_size=batch_size, drop_last=True,
                         seed=config.get("seed", 2024))
    result = trainer.fit(loader, epochs=config.get("epochs"))
    if test_arrays is not None:
        test_eval = CTREvaluator(test_arrays, label=label, metrics=metrics,
                                 group_id=group_id)
        result = {**result, **{f"test_{k}": v
                               for k, v in test_eval(trainer).items()}}
    logger.info("experiment %s: %s", config.get("experiment_id", "?"), result)
    return result


class _ListModel(torch.nn.Module):
    """The trainer's model contract over a listwise reranker: ``model(batch)``
    scores ``batch["item_feats"]`` under ``batch["mask"]`` (JAX's
    ``_Shim``)."""

    def __init__(self, inner: torch.nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.inner(batch["item_feats"], batch["mask"])


class _ListLoader:
    """Shuffled full batches of lists, a permutation an epoch."""

    def __init__(self, lists, batch_size, seed):
        self.lists = lists
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.n = len(lists["labels"])

    def __iter__(self):
        idx = self.rng.permutation(self.n)
        bs = self.batch_size
        for s in range(0, (self.n // bs) * bs, bs):
            sel = idx[s:s + bs]
            yield {k: v[sel] for k, v in self.lists.items()}


def run_rerank_experiment(
    config: Mapping[str, Any],
    train_lists: Dict[str, np.ndarray],
    valid_lists: Dict[str, np.ndarray],
    ks=(5, 10),
    mesh=None,
    device: Device = None,
) -> Dict[str, float]:
    """Listwise rerank pipeline (librerank's protocol): lists are dicts of
    item_feats (B, N, D), labels (B, N), mask (B, N); listwise-BCE
    training, MAP / NDCG / clicks@k on ``valid_lists``
    (`evaluate_rerank`). The model's input width is the lists' D."""
    from recbox_tpu_torch.evaluation.rerank import evaluate_rerank
    from recbox_tpu_torch.models.reranking.models import listwise_bce

    config = Config(config)
    dev = resolve_device(device)
    model = build_reranker(config, int(train_lists["item_feats"].shape[-1]),
                           dev)
    valid_batch = {"item_feats": valid_lists["item_feats"],
                   "mask": valid_lists["mask"]}

    def evaluate(trainer):
        scores = trainer.apply(valid_batch).float().cpu().numpy()
        return evaluate_rerank(scores, valid_lists["labels"],
                               valid_lists["mask"], ks=ks)

    trainer = Trainer(_ListModel(model), lambda o, b: listwise_bce(
        o, b["labels"], b["mask"]), build_trainer_config(config),
        eval_fn=evaluate, mesh=mesh, device=dev)
    loader = _ListLoader(train_lists, config.get("batch_size", 256),
                         config.get("seed", 2024))
    trainer.fit(loader, epochs=config.get("epochs"))
    result = evaluate(trainer)
    logger.info("rerank experiment: %s", result)
    return result


def _not_ported(name: str):
    def run(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet "
                                  f"{_ORCHESTRATION}")
    run.__name__ = run.__qualname__ = name
    run.__doc__ = f"Not ported yet {_ORCHESTRATION}: raises."
    return run


run_matching_experiment = _not_ported("run_matching_experiment")
run_sequential_experiment = _not_ported("run_sequential_experiment")
run_kg_experiment = _not_ported("run_kg_experiment")
run_experiment = _not_ported("run_experiment")


def _user2items(split) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for u, i in zip(split.user_ids, split.item_ids):
        out.setdefault(int(u), []).append(int(i))
    return out


def _acquire_interactions(dataset: str, cfg: Mapping[str, Any],
                          data_dir: Optional[str]):
    """Acquire by name, load the atomic files, build the interactions:
    (dataset, interactions, rating field, time field)."""
    from recbox_tpu_torch.data.acquire import acquire_dataset
    from recbox_tpu_torch.data.atomic import load_atomic_dataset

    # `dataset_dir` is the acquisition cache root
    folder = acquire_dataset(dataset,
                             data_dir or cfg.get("dataset_dir", "datasets"),
                             url=cfg.get("dataset_url"),
                             checksum=cfg.get("dataset_sha256"))
    uf = cfg.get("user_field", "user_id")
    itf = cfg.get("item_field", "item_id")
    ds = load_atomic_dataset(folder, dataset, user_field=uf, item_field=itf)
    rf = cfg.get("rating_field",
                 "rating" if "rating" in ds.inter else None)
    tf = cfg.get("time_field",
                 "timestamp" if "timestamp" in ds.inter else None)
    inter = ds.to_interactions(user_field=uf, item_field=itf,
                               rating_field=rf, time_field=tf)
    return ds, inter, rf, tf


def _filter_and_remap(inter, cfg: Mapping[str, Any]):
    """min_rating / k-core filters, then a contiguous remap (ids start at
    1; 0 stays the PAD / OOV row downstream)."""
    if cfg.get("min_rating") is not None:
        inter = inter.filter_by_rating(float(cfg["min_rating"]))
    if cfg.get("min_user_inter") or cfg.get("min_item_inter"):
        inter = inter.filter_by_count(
            int(cfg.get("min_user_inter", 0) or 0),
            int(cfg.get("min_item_inter", 0) or 0))
    return inter.remap_ids(start=1)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _candidate_lists(user_embs: np.ndarray, item_embs: np.ndarray,
                     users: np.ndarray, hist_maps, k: int,
                     exclude) -> np.ndarray:
    """The cascade's candidates: the top-k unseen items of each user by
    the matcher's dot product, best first (JAX `quick_start.py:1022-1038`,
    in chunks of 1024 users, never the whole (U, I) matrix).

    Kept from JAX for parity (`ADVICE.md:3`, JAX :1033): a user whose
    unseen pool is smaller than k gets the rest of its k slots from its
    seen items, scored −inf, in `np.argpartition`'s order."""
    out = np.empty((len(users), k), np.int64)
    for s in range(0, len(users), 1024):
        us = users[s:s + 1024]
        sc = user_embs[us] @ item_embs.T
        for r, u in enumerate(us):
            seen = list(exclude)
            for h in hist_maps:
                seen.extend(h.get(int(u), ()))
            sc[r, seen] = -np.inf
        idx = np.argpartition(-sc, kth=min(k, sc.shape[1] - 1),
                              axis=1)[:, :k]
        row_s = np.take_along_axis(sc, idx, axis=1)
        ordr = np.argsort(-row_s, axis=1, kind="stable")
        out[s:s + 1024] = np.take_along_axis(idx, ordr, axis=1)
    return out


def _ctr_rows(dset, hist_maps, rng: np.random.Generator, n_items: int,
              neg_per_pos: int, exclude, hard_pool: Mapping[int, np.ndarray]):
    """(users, items, labels) of the ranker's rows: each positive of
    ``dset``, ``neg_per_pos - neg_per_pos // 2`` uniform negatives drawn
    anew (four rounds) where they hit a seen item, ``neg_per_pos // 2``
    hard ones from the user's pool of matcher candidates, then a
    permutation; ``rng``'s calls in JAX's order (JAX :1071-1101).

    Kept from JAX for parity (`ADVICE.md:4`, JAX :1090): a user without a
    hard pool gets a uniform item for each hard negative, and a seen item
    drawn there is not drawn again."""
    pos_u = dset.user_ids.astype(np.int64)
    pos_i = dset.item_ids.astype(np.int64)
    n_hard = neg_per_pos // 2
    n_rand = neg_per_pos - n_hard
    neg_u = np.repeat(pos_u, n_rand)
    neg_i = rng.integers(0, n_items, len(neg_u))
    seen: Dict[int, set] = {}
    for h in hist_maps:
        for u, its in h.items():
            seen.setdefault(int(u), set()).update(its)
    for _ in range(4):   # resample seen collisions, a few rounds
        bad = np.array([i in seen.get(int(u), ()) or i in exclude
                        for u, i in zip(neg_u, neg_i)])
        if not bad.any():
            break
        neg_i[bad] = rng.integers(0, n_items, int(bad.sum()))
    hu = np.repeat(pos_u, n_hard)
    hi = np.empty(len(hu), np.int64)
    for r, u in enumerate(hu):
        pool = hard_pool.get(int(u))
        hi[r] = pool[rng.integers(0, len(pool))] if pool is not None \
            else rng.integers(0, n_items)
    u = np.concatenate([pos_u, neg_u, hu])
    i = np.concatenate([pos_i, neg_i, hi])
    y = np.concatenate([np.ones(len(pos_u), np.float32),
                        np.zeros(len(neg_u) + len(hu), np.float32)])
    p = rng.permutation(len(u))
    return u[p], i[p], y[p]


def run_cascade_experiment(
    dataset: str,
    matcher: str = "MF",
    ranker: str = "DCN",
    reranker: str = "PRM",
    config: Optional[Mapping[str, Any]] = None,
    data_dir: Optional[str] = None,
    mesh=None,
    device: Device = None,
    timings: Optional[Dict[str, float]] = None,
    **overrides,
) -> Dict[str, float]:
    """The three-stage cascade, matching → ranking → reranking, as one call
    from a dataset name, with JAX's leakage-clean protocol:

      split   0.8 / 0.1 / 0.1 a user ('RO', or 'TO' with timestamps);
      stage 1 ``matcher`` trained with sampled negatives, full-sort valid
              evaluation; candidate lists: the top-``candidates`` unseen
              items a user (valid lists mask train, test lists train ∪
              valid);
      stage 2 ``ranker`` on train positives and mixed negatives (half
              uniform unseen, half hard: the matcher's candidates that are
              not known positives), the matcher's score a numeric feature;
              it re-scores and prunes the lists to ``list_len``;
      stage 3 ``reranker`` trained on valid-labeled lists, evaluated on
              test-labeled lists; a slot's features [user emb ‖ item emb ‖
              matcher score ‖ ranker score].

    Returns stage 1's valid / test metrics and candidate recall, stage 2's
    AUC / logloss, and NDCG@k of the test lists under the matcher's, the
    ranker's and the reranker's order (``stage3_*``). The host work (the
    candidates, the negatives and their rng calls in JAX's order) is
    numpy, as in JAX; the three models train on ``device``.

    Two behaviours are JAX's and kept for parity (`ADVICE.md:3-4`, JAX
    `quick_start.py:1033` and :1090): a user whose unseen pool is smaller
    than ``candidates`` gets candidate slots filled with −inf-scored seen
    items (`_candidate_lists`), and the hard-negative fallback of a user
    without a hard pool draws a uniform item without resampling the
    user's seen items (`_ctr_rows`).

    ``timings``, a dict the caller passes (the port's addition), receives
    the wall seconds of the data preparation and of each stage
    (``data_s``, ``stage1_s``, ``stage2_s``, ``stage3_s``; a stage's
    host work counts to it).

    Knobs beyond the data ones: matcher_epochs=5, ranker_epochs=3,
    reranker_epochs=5, candidates=100, list_len=20, neg_per_pos=3,
    embedding_dim=32, topk_eval=(10, 20); each stage's model
    hyperparameters pass through by argument name.
    """
    from recbox_tpu_torch.evaluation.ctr import auc_score, log_loss
    from recbox_tpu_torch.evaluation.rerank import evaluate_rerank
    from recbox_tpu_torch.features.schema import FeatureSpec

    dev = resolve_device(device)
    cfg = dict(config or {})
    cfg.update(overrides)
    seed = cfg.get("seed", 2024)
    emb_dim = cfg.get("embedding_dim", 32)
    n_cand = int(cfg.get("candidates", 100))
    list_len = int(cfg.get("list_len", 20))
    neg_per_pos = int(cfg.get("neg_per_pos", 3))
    ks = tuple(cfg.get("topk_eval", (10, 20)))
    rng = np.random.default_rng(seed)
    timings = {} if timings is None else timings
    clock = [time.perf_counter()]

    def lap(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[name] = now - clock[0]
        clock[0] = now

    # --- data: acquire / filter / per-user split -------------------------
    _, inter, rf, tf = _acquire_interactions(dataset, cfg, data_dir)
    inter = _filter_and_remap(inter, cfg)
    n_users, n_items = inter.num_users, inter.num_items
    order = cfg.get("order", "TO" if inter.timestamps is not None else "RO")
    train, valid, test = inter.split_ratio(
        tuple(cfg.get("split_ratios", (0.8, 0.1, 0.1))), order=order,
        group_by_user=True, seed=seed)
    train_u2i, valid_u2i, test_u2i = map(_user2items, (train, valid, test))
    if not valid_u2i or not test_u2i:
        raise ValueError(
            f"dataset {dataset!r}: cascade needs non-empty valid AND test "
            "splits (per-user ratio split — users need >= 10 interactions "
            "at the default 0.8/0.1/0.1)")

    fm = FeatureMap(dataset, (
        FeatureSpec("user_id", "categorical", source="user",
                    vocab_size=n_users, embedding_dim=emb_dim),
        FeatureSpec("item_id", "categorical", source="item",
                    vocab_size=n_items, embedding_dim=emb_dim)),
        labels=("click",), query_index="user_id", corpus_index="item_id",
        num_items=n_items)
    corpus = {"item_id": np.arange(n_items, dtype=np.int32)}
    exclude = tuple(cfg.get("exclude_items", (0,)))
    lap("data_s")

    # --- stage 1: matcher ------------------------------------------------
    _, m_stage = get_model(matcher)
    if m_stage != "matching":
        raise ValueError(f"matcher {matcher!r} is stage {m_stage!r}")
    metrics = list(cfg.get("metrics", ["Recall(k=20)", "NDCG(k=10)"]))
    cfg1 = {**cfg, "model": matcher,
            "epochs": cfg.get("matcher_epochs", 5),
            "monitor": cfg.get("monitor", metrics[0])}
    m_model, _ = build_model(Config(cfg1), fm, dev)
    loader = MatchingLoader(
        fm, {"user_id": train.user_ids.astype(np.int32),
             "item_id": train.item_ids.astype(np.int32)},
        corpus, batch_size=cfg.get("batch_size", 512),
        num_negs=cfg.get("num_negs", 1), seed=seed, exclude_seen=True,
        exclude_ids=exclude)
    vu = np.asarray(sorted(valid_u2i), np.int64)
    tu = np.asarray(sorted(test_u2i), np.int64)
    evaluator = RetrievalEvaluator(
        {"user_id": vu.astype(np.int32)}, corpus, vu, train_u2i, valid_u2i,
        metrics=metrics, exclude_items=exclude)
    match_loss = get_matching_loss(cfg.get("loss", "PairwiseLogisticLoss"))
    t_match = Trainer(m_model, lambda o, b: match_loss(o),
                      build_trainer_config(cfg1), eval_fn=evaluator,
                      mesh=mesh, device=dev)
    stage1_valid = t_match.fit(loader)
    merged_hist: Dict[int, list] = {}
    for u2i in (train_u2i, valid_u2i):
        for u, its in u2i.items():
            merged_hist.setdefault(int(u), []).extend(its)
    test_eval = RetrievalEvaluator(
        {"user_id": tu.astype(np.int32)}, corpus, tu, merged_hist,
        test_u2i, metrics=metrics, exclude_items=exclude)
    stage1_test = test_eval(t_match)

    # encode all users and the whole corpus once for the later stages
    all_users = RetrievalEvaluator(
        {"user_id": np.arange(n_users, dtype=np.int32)}, corpus,
        np.arange(n_users), {}, {})
    user_embs, item_embs = map(_numpy, all_users.encode_all(t_match))

    def pair_scores(u, i):
        return np.einsum("nd,nd->n", user_embs[u], item_embs[i])

    _tr_sc = pair_scores(train.user_ids, train.item_ids)
    _mu, _sd = float(_tr_sc.mean()), float(_tr_sc.std() + 1e-8)

    def match_feat(u, i):
        return ((pair_scores(u, i) - _mu) / _sd).astype(np.float32)

    valid_cand = _candidate_lists(user_embs, item_embs, vu, (train_u2i,),
                                  n_cand, exclude)
    test_cand = _candidate_lists(user_embs, item_embs, tu,
                                 (train_u2i, valid_u2i), n_cand, exclude)

    def relevance(users, cand, u2i):
        out = np.zeros(cand.shape, np.float32)
        for r, u in enumerate(users):
            pos = set(u2i[int(u)])
            out[r] = [1.0 if i in pos else 0.0 for i in cand[r]]
        return out

    rel_valid = relevance(vu, valid_cand, valid_u2i)
    rel_test = relevance(tu, test_cand, test_u2i)
    cand_recall = float(np.mean(
        rel_test.sum(1) / np.maximum([len(test_u2i[int(u)]) for u in tu],
                                     1)))
    lap("stage1_s")

    # --- stage 2: ranker -------------------------------------------------
    _, r_stage = get_model(ranker)
    if r_stage != "ranking":
        raise ValueError(f"ranker {ranker!r} is stage {r_stage!r}")
    hard_pool = {}
    for r, u in enumerate(vu):
        vset = set(valid_u2i.get(int(u), ()))
        pool = [i for i in valid_cand[r] if i not in vset]
        if pool:
            hard_pool[int(u)] = np.asarray(pool, np.int64)

    def make_ctr(dset, hist_maps):
        u, i, y = _ctr_rows(dset, hist_maps, rng, n_items, neg_per_pos,
                            exclude, hard_pool)
        return {"user_id": u.astype(np.int32), "item_id": i.astype(np.int32),
                "match_score": match_feat(u, i), "click": y}

    ctr_train = make_ctr(train, (train_u2i,))
    ctr_valid = make_ctr(valid, (train_u2i, valid_u2i))
    fm_rank = FeatureMap(f"{dataset}_rank", (
        FeatureSpec("user_id", "categorical", source="user",
                    vocab_size=n_users, embedding_dim=emb_dim),
        FeatureSpec("item_id", "categorical", source="item",
                    vocab_size=n_items, embedding_dim=emb_dim),
        FeatureSpec("match_score", "numeric", embedding_dim=emb_dim)),
        labels=("click",))
    cfg2 = {**cfg, "model": ranker, "epochs": cfg.get("ranker_epochs", 3)}
    r_model, _ = build_model(Config(cfg2), fm_rank, dev)
    t_rank = Trainer(r_model,
                     lambda o, b: binary_crossentropy(o, b["click"]),
                     build_trainer_config(cfg2), mesh=mesh, device=dev)
    # capped at the row count: drop_last would otherwise yield no batch
    rank_loader = ArrayLoader(
        ctr_train,
        batch_size=min(cfg.get("ranker_batch_size", 8192),
                       len(ctr_train["click"])),
        drop_last=True, seed=seed)
    for _ep in range(cfg.get("ranker_epochs", 3)):
        for batch in rank_loader:
            batch.pop("__mask__", None)
            t_rank.train_step(batch)

    def ranker_scores(u, i):
        out = []
        for s in range(0, len(u), 65536):
            us, its = u[s:s + 65536], i[s:s + 65536]
            out.append(_numpy(t_rank.apply(
                {"user_id": us.astype(np.int32),
                 "item_id": its.astype(np.int32),
                 "match_score": match_feat(us, its)})))
        return np.concatenate(out)

    vpred = ranker_scores(ctr_valid["user_id"], ctr_valid["item_id"])
    stage2_auc = auc_score(ctr_valid["click"], vpred)
    stage2_ll = log_loss(ctr_valid["click"], 1.0 / (1.0 + np.exp(-vpred)))

    def score_lists(users, cand):
        b, k = cand.shape
        return ranker_scores(np.repeat(users, k),
                             cand.reshape(-1)).reshape(b, k)

    rank_valid = score_lists(vu, valid_cand)
    rank_test = score_lists(tu, test_cand)

    def truncate(cand, scores, rel, k):
        """The ranker prunes the candidates to the listwise window."""
        o = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(cand, o, axis=1),
                np.take_along_axis(scores, o, axis=1),
                np.take_along_axis(rel, o, axis=1))

    vc, vs, vr = truncate(valid_cand, rank_valid, rel_valid, list_len)
    tc, ts, tr_ = truncate(test_cand, rank_test, rel_test, list_len)

    # ordering quality of the two upstream stages on the test lists: the
    # full candidate lists, and the truncated ones stage 3 is judged on
    matcher_order = evaluate_rerank(
        -np.arange(n_cand, dtype=np.float64)[None].repeat(len(tu), 0),
        rel_test, ks=list(ks))
    ranker_order = evaluate_rerank(rank_test, rel_test, ks=list(ks))
    tc_match_scores = match_feat(np.repeat(tu, list_len),
                                 tc.reshape(-1)).reshape(tc.shape)
    list_matcher = evaluate_rerank(tc_match_scores, tr_, ks=list(ks))
    list_ranker = evaluate_rerank(ts, tr_, ks=list(ks))
    lap("stage2_s")

    # --- stage 3: reranker -----------------------------------------------
    def slot_feats(users, cand, scores):
        b, k = cand.shape
        fu = np.repeat(users, k)
        fi = cand.reshape(-1)
        return np.concatenate([
            np.repeat(user_embs[users][:, None, :], k, axis=1),
            item_embs[fi].reshape(b, k, -1),
            match_feat(fu, fi).reshape(b, k, 1),
            scores[..., None]], axis=-1).astype(np.float32)

    cfg3 = {**cfg, "model": reranker,
            "epochs": cfg.get("reranker_epochs", 5),
            # never more than the lists: the list loader drops ragged tails
            "batch_size": min(cfg.get("reranker_batch_size", 256), len(vu)),
            "monitor": f"NDCG@{ks[0]}"}
    cfg3.setdefault("max_list_len", list_len)
    train_lists = {"item_feats": slot_feats(vu, vc, vs),
                   "labels": vr, "mask": np.ones(vr.shape, bool)}
    test_lists = {"item_feats": slot_feats(tu, tc, ts),
                  "labels": tr_, "mask": np.ones(tr_.shape, bool)}
    stage3 = run_rerank_experiment(cfg3, train_lists, test_lists,
                                   ks=list(ks), mesh=mesh, device=dev)
    lap("stage3_s")

    result: Dict[str, float] = {}
    result.update({f"stage1_{k}": v for k, v in stage1_valid.items()})
    result.update({f"stage1_test_{k}": v for k, v in stage1_test.items()})
    result["candidate_recall"] = cand_recall
    result["stage2_AUC"] = stage2_auc
    result["stage2_logloss"] = stage2_ll
    for k in ks:
        result[f"matcher_order_NDCG@{k}"] = matcher_order[f"NDCG@{k}"]
        result[f"ranker_order_NDCG@{k}"] = ranker_order[f"NDCG@{k}"]
        result[f"list_matcher_NDCG@{k}"] = list_matcher[f"NDCG@{k}"]
        result[f"list_ranker_NDCG@{k}"] = list_ranker[f"NDCG@{k}"]
    result.update({f"stage3_{k}": v for k, v in stage3.items()})
    logger.info("cascade %s/%s/%s on %s: %s", matcher, ranker, reranker,
                dataset, result)
    return result
