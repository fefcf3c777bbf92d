"""One-call experiment pipelines, from a dataset name or arrays to metrics.

Counterpart of `recbox_tpu/quick_start.py`: `_use_fused_ce` (:41-81),
`build_model` (:84), `build_trainer_config` (:95), `run_ranking_experiment`
(:101, with ``trainer: packed`` → `PackedEmbeddingTrainer`, :135-142),
`run_matching_experiment` (:162-261), `run_sequential_experiment`
(:264-386), `run_rerank_experiment` (:389), `_user2items`,
`_acquire_interactions` and `_filter_and_remap` (:603-645),
`run_experiment` (:647-883) and `run_cascade_experiment` (:886-1213).
A model's hyperparameters come from the config by the names of its
constructor's arguments (JAX's: its dataclass fields); its initial draw
from a host generator seeded with the config's ``seed`` (2024 by default;
JAX draws it from ``TrainerConfig.seed``, the same key), so a seed gives the
same initial weights on the card as on the CPU, as JAX's threefry draws do
on every backend (`_seeded_build`). Every entry point
takes ``device=`` and runs on the CUDA device unless the caller names
another (`recbox_tpu_torch.resolve_device`, which raises without a card).
``mesh`` (`parallel.make_mesh`) reaches the trainers and the services as
in JAX: each process passes its rank's rows, the tables row-shard, and
every rank runs the pipeline together (the fused CE kernel is refused
under a mesh, `_use_fused_ce`).

The sequential pipeline scores its evaluation chunks on the device and
ranks there: a row's hit position under 'full' is the count of items that
score above the target plus those that score equal and come before it in
index order (JAX copies the (rows, V) scores to the host and argsorts
them; the positions agree wherever the target's score is untied, and JAX's
quicksort has no fixed tie order). Under 'uniN' / 'popN' the candidates
are JAX's numpy draws, value for value, and the position is the stable
sort's, as in JAX.

`run_kg_experiment` (:484-600) alternates a CF phase and a KG phase
(``model.kg_loss`` under its own Adam) each epoch; its KG batches are
JAX's numpy draws, value for value. `run_experiment` on a knowledge model
remaps items and entities jointly (`AtomicDataset.filter_interactions`)
and fills the graph's sizes (:708-725, :868-878); a knowledge model whose
graph arrays it does not fill raises, as JAX's does.
`run_ranking_experiment` trains a multitask model on `multitask_loss` over
the labels and evaluates it with `MultiTaskEvaluator`, both reading
probabilities where the model's ``output_type`` is 'probs' (ESMM), as in
JAX (:117-126, :149-156).

`run_cascade_experiment` keeps two behaviours of the reference that
`ADVICE.md:3-4` records as defects, so that both packages compute the same
cascade (see its docstring).
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from recbox_tpu_torch import resolve_device
from recbox_tpu_torch.config.config import Config
from recbox_tpu_torch.data import ArrayLoader, MatchingLoader
from recbox_tpu_torch.evaluation.evaluators import (
    CTREvaluator, MultiTaskEvaluator, RetrievalEvaluator,
)
from recbox_tpu_torch.features.schema import FeatureMap
from recbox_tpu_torch.models.registry import get_model
from recbox_tpu_torch.ops.losses import (
    binary_crossentropy, full_softmax_loss, get_matching_loss,
)
from recbox_tpu_torch.training import Trainer, TrainerConfig
from recbox_tpu_torch.training.trainer import _ForeachAdam

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["build_model", "build_reranker", "build_trainer_config",
           "run_ranking_experiment", "run_matching_experiment",
           "run_sequential_experiment", "run_rerank_experiment",
           "run_kg_experiment", "run_experiment", "run_cascade_experiment"]

Device = Optional[Union[str, torch.device]]


def _use_fused_ce(config: Mapping[str, Any], feature_map: FeatureMap,
                  model, mesh=None) -> bool:
    """Whether the sequential CE trains through kernel B2
    (``fused_ce_loss``) instead of the (B, V) logits (``full_scores``):
    JAX's gate, gate for gate and in its order.

    Correctness gates first, and they override an explicit ``fused_ce:
    True`` (with JAX's warning): the kernel computes the base
    ``full_scores`` protocol (plain dot / temperature), so a model that
    overrides ``full_scores`` or ``fused_ce_loss`` (CORE's cosine,
    RepeatNet's mixture) keeps the logits, and so does a mesh run. Then an
    explicit ``fused_ce`` decides. Otherwise the kernel takes models that
    already compute in bf16 with a corpus of at least
    ``fused_ce_threshold`` (150,000) items."""
    from recbox_tpu_torch.models.sequential.models import (
        SequentialRecommender,
    )

    if not isinstance(model, SequentialRecommender):
        return False
    overridden = (
        type(model).full_scores is not SequentialRecommender.full_scores
        or type(model).fused_ce_loss
        is not SequentialRecommender.fused_ce_loss)
    if overridden or mesh is not None:
        if config.get("fused_ce"):
            logger.warning(
                "fused_ce requested but %s — keeping the XLA "
                "full_scores path",
                "the model overrides full_scores (its scoring protocol "
                "is not the plain dot the kernel computes)" if overridden
                else "the flash-CE kernel is single-shard (mesh run)")
        return False
    if "fused_ce" in config:
        return bool(config["fused_ce"])
    n_corpus = feature_map[feature_map.corpus_index].vocab_size
    return (n_corpus >= int(config.get("fused_ce_threshold", 150_000))
            and getattr(model, "compute_dtype", None) == "bfloat16")


def _init_arguments(cls) -> set:
    """The named arguments of ``cls``'s constructor and, where it passes
    ``**kwargs`` on, of its bases' (JAX's dataclass fields include the
    inherited ones)."""
    names = set()
    for klass in cls.__mro__:
        if "__init__" not in vars(klass):
            continue
        params = inspect.signature(klass.__init__).parameters.values()
        names |= {p.name for p in params
                  if p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL)}
        if not any(p.kind == p.VAR_KEYWORD for p in params):
            break
    return names


def _model_kwargs(cls, config: Mapping[str, Any]) -> Dict[str, Any]:
    """The config's entries that name arguments of ``cls``'s constructor
    (lists as tuples), as JAX's picks its dataclass fields."""
    names = _init_arguments(cls) - {
        "self", "feature_map", "generator", "device", "in_dim"}
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in config.items() if k in names}


def _seeded_build(make: Callable, config: Mapping[str, Any],
                  device: torch.device) -> torch.nn.Module:
    """``make(generator, device)``, its parameters and buffers drawn on the
    host from a generator seeded with the config's ``seed``. Off the CPU
    the model is built on ``device`` as well (from a generator of that
    device with the same seed, which a model may keep) and takes the host
    draw's state: a card's generator gives another stream than the CPU's
    for one seed, and JAX's draws are the same on every backend."""
    seed = int(config.get("seed", 2024))
    host = make(torch.Generator().manual_seed(seed), torch.device("cpu"))
    if device.type == "cpu":
        return host
    model = make(torch.Generator(device=device).manual_seed(seed), device)
    model.load_state_dict(host.state_dict())
    return model


def build_model(config: Mapping[str, Any], feature_map: FeatureMap,
                device: Device = None):
    """(model, stage): the configured model, given the config keys that
    match its constructor's arguments (embedding_dim, hidden_units, ...),
    drawn from a generator seeded with the config's ``seed``."""
    cls, stage = get_model(config["model"])
    dev = resolve_device(device)
    # by keyword, as JAX's: a model that takes no feature map (the
    # autoencoders, Item2Vec) raises TypeError in both packages
    kwargs = _model_kwargs(cls, config)
    return _seeded_build(
        lambda g, d: cls(feature_map=feature_map, **kwargs, generator=g,
                         device=d), config, dev), stage


def build_reranker(config: Mapping[str, Any], in_dim: int,
                   device: Device = None) -> torch.nn.Module:
    """The configured listwise reranker over ``in_dim``-wide slot features
    (JAX's infers the width at init), drawn as `build_model` draws."""
    cls, stage = get_model(config["model"])
    if stage != "reranking":
        raise ValueError(f"{config['model']} is not a reranker")
    kwargs = _model_kwargs(cls, config)
    return _seeded_build(
        lambda g, d: cls(in_dim, **kwargs, generator=g, device=d), config,
        resolve_device(device))


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
    """CTR / multitask pipeline: loader → model → trainer.fit → metrics
    (valid, and ``test_*`` with ``test_arrays``). ``trainer: packed`` in
    the config trains the tables with `PackedEmbeddingTrainer` (one row
    gather and one B1 update a step)."""
    config = Config(config)
    dev = resolve_device(device)
    model, stage = build_model(config, feature_map, dev)
    batch_size = config.get("batch_size", 2048)
    labels = list(feature_map.labels)
    metrics = list(config.get("metrics", ["AUC", "logloss"]))
    group_id = config.get("group_id") or None
    from_logits = getattr(model, "output_type", "logits") == "logits"

    def make_evaluator(arrays):
        if stage == "multitask":
            return MultiTaskEvaluator(arrays, labels, metrics=metrics,
                                      from_logits=from_logits)
        return CTREvaluator(arrays, label=labels[0], metrics=metrics,
                            group_id=group_id)

    evaluator = make_evaluator(valid_arrays)
    if stage == "multitask":
        from recbox_tpu_torch.models.multitask import multitask_loss

        def loss_fn(outputs, batch):
            y = torch.stack([batch[name] for name in labels], dim=1)
            return multitask_loss(outputs, y, from_logits=from_logits)
    else:
        def loss_fn(outputs, batch):
            return binary_crossentropy(outputs, batch[labels[0]])

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
        result = {**result, **{f"test_{k}": v for k, v in
                               make_evaluator(test_arrays)(trainer).items()}}
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
    (`evaluate_rerank`). The model's input width is the lists' D.

    Every reranking name trains here as in JAX: EGR / EGREvaluator under
    the listwise BCE; PPOReranker's greedy scores carry no gradient, so
    its step moves nothing (zero gradients); EGRDiscriminator's (B,) logit
    against (B, N) labels fails in `listwise_bce` unless B == N, in both
    packages."""
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


def run_matching_experiment(
    config: Mapping[str, Any],
    feature_map: FeatureMap,
    train_arrays: Dict[str, np.ndarray],
    corpus_arrays: Dict[str, np.ndarray],
    eval_user_arrays: Dict[str, np.ndarray],
    query_indices: np.ndarray,
    train_user2items: Mapping[int, Any],
    valid_user2items: Mapping[int, Any],
    mesh=None,
    test_user2items: Optional[Mapping[int, Any]] = None,
    test_user_arrays: Optional[Dict[str, np.ndarray]] = None,
    device: Device = None,
) -> Dict[str, float]:
    """Two-tower / graph / sequential matching pipeline with retrieval
    evaluation. ``loss: FullSoftmaxCE`` trains a sequential model on
    whole-vocabulary CE (through B2 where `_use_fused_ce` opens); any other
    loss trains on `MatchingLoader`'s sampled negatives. With
    ``test_user2items`` the best-valid weights are evaluated on them after
    `fit`, train ∪ valid positives masked (recbole's test phase), as
    ``test_*`` keys. The protocol and beyond-accuracy keys
    (``eval_protocol``, ``beyond_accuracy_metrics``, ``beyond_topk``,
    ``exclude_items``) reach both evaluators."""
    config = Config(config)
    dev = resolve_device(device)
    model, _ = build_model(config, feature_map, dev)
    metrics = list(config.get("metrics", ["Recall(k=20)", "NDCG(k=10)"]))

    def evaluator(users, queries, masks, truth):
        return RetrievalEvaluator(
            users, corpus_arrays, queries, masks, truth, metrics=metrics,
            batch_size=config.get("eval_batch_size", 4096),
            beyond_accuracy_metrics=config.get("beyond_accuracy_metrics",
                                               ()),
            beyond_topk=config.get("beyond_topk", 20),
            protocol=config.get("eval_protocol", "full"),
            protocol_seed=config.get("seed", 2024),
            exclude_items=tuple(config.get("exclude_items", ())))

    loss_name = config.get("loss", "PairwiseLogisticLoss")
    train_method = None
    if loss_name == "FullSoftmaxCE":
        if _use_fused_ce(config, feature_map, model, mesh):
            train_method = "fused_ce_loss"
            logger.info("FullSoftmaxCE: flash-CE kernel path (%d items)",
                        feature_map[feature_map.corpus_index].vocab_size)

            def loss_fn(outputs, batch):
                return outputs
        else:
            train_method = "full_scores"

            def loss_fn(outputs, batch):
                return full_softmax_loss(outputs,
                                         batch[feature_map.corpus_index])

        loader = ArrayLoader(train_arrays,
                             batch_size=config.get("batch_size", 2048),
                             drop_last=True, seed=config.get("seed", 2024))
    else:
        match_loss = get_matching_loss(loss_name)

        def loss_fn(outputs, batch):
            return match_loss(outputs)

        loader = MatchingLoader(
            feature_map, train_arrays, corpus_arrays,
            batch_size=config.get("batch_size", 2048),
            num_negs=config.get("num_negs", 10),
            seed=config.get("seed", 2024),
            exclude_ids=tuple(config.get("exclude_items", ())))

    trainer = Trainer(model, loss_fn, build_trainer_config(config),
                      eval_fn=evaluator(eval_user_arrays, query_indices,
                                        train_user2items, valid_user2items),
                      mesh=mesh, device=dev, train_method=train_method)
    result = trainer.fit(loader, epochs=config.get("epochs"))
    if test_user2items:
        tq = np.asarray(sorted(test_user2items), dtype=np.int64)
        tu = test_user_arrays if test_user_arrays is not None else {
            (feature_map.query_index or "user_id"): tq.astype(np.int32)}
        merged: Dict[int, list] = {}
        for u2i in (train_user2items, valid_user2items):
            for u, its in u2i.items():
                merged.setdefault(int(u), []).extend(int(i) for i in its)
        test_eval = evaluator(tu, tq, merged, test_user2items)
        result = {**result, **{f"test_{k}": v
                               for k, v in test_eval(trainer).items()}}
    logger.info("experiment %s: %s", config.get("experiment_id", "?"), result)
    return result


def _eval_candidates(protocol: str, split: Mapping[str, np.ndarray],
                     feature_map: FeatureMap, train_items: np.ndarray,
                     config: Mapping[str, Any]) -> np.ndarray:
    """(rows, 1 + N) int64 candidates of a 'uniN' / 'popN' protocol, the
    target in column 0: JAX's draws (`quick_start.py:285-323`) call for
    call — a generator from ``seed``, uniform ids in [1, num_items) or
    `AliasTable` draws over the train counts, the row's history, target
    and excluded ids drawn again up to 20 rounds."""
    from recbox_tpu_torch.data.sampling import AliasTable
    from recbox_tpu_torch.evaluation.candidate import parse_protocol

    dist, n_neg = parse_protocol(protocol)
    rng = np.random.default_rng(config.get("seed", 2024))
    tgt = split[feature_map.corpus_index]
    n_items = feature_map.num_items
    excluded = set(int(x) for x in config.get("exclude_items", ()))
    excluded.add(0)                       # the PAD row
    if dist == "popularity":
        counts = np.bincount(train_items, minlength=n_items).astype(
            np.float64)
        for e in excluded:
            if 0 <= e < n_items:
                counts[e] = 0.0
        alias = AliasTable(counts if counts.sum() else np.ones(n_items))

        def draw(size):
            return alias.sample(size, rng)
    else:
        def draw(size):
            return rng.integers(1, n_items, size=size)
    negs = draw((len(tgt), n_neg))
    excl_arr = np.asarray(sorted(excluded), np.int64)
    hist = split["item_seq"]
    for _ in range(20):
        bad = (negs[:, :, None] == hist[:, None, :]).any(-1) \
            | (negs == tgt[:, None]) | np.isin(negs, excl_arr)
        if not bad.any():
            break
        negs[bad] = draw(int(bad.sum()))
    return np.concatenate([tgt[:, None], negs], axis=1).astype(np.int64)


def hit_positions(scores: torch.Tensor, targets: torch.Tensor,
                  candidates: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """0-based rank of each row's target, on the scores' device.

    'full' (``candidates`` None): the items that score above the target,
    plus those that score equal and come before it in index order.
    Candidates (target in column 0): the columns that score above it, the
    position of column 0 in a stable descending sort. Sharded logits
    (a mesh's row-sharded table) rank over every rank's columns
    (`parallel.mesh.sharded_hit_positions`)."""
    from recbox_tpu_torch.parallel.mesh import (
        ShardedLogits, sharded_hit_positions,
    )
    if isinstance(scores, ShardedLogits):
        return sharded_hit_positions(scores, targets, candidates)
    if candidates is not None:
        cs = torch.gather(scores, 1, candidates)
        return torch.sum(cs[:, 1:] > cs[:, :1], dim=1)
    ts = torch.gather(scores, 1, targets[:, None])
    before = torch.arange(scores.shape[1], device=scores.device)[None, :] \
        < targets[:, None]
    return torch.sum((scores > ts) | ((scores == ts) & before), dim=1)


def rank_metrics(pos: np.ndarray, ks) -> Dict[str, float]:
    """Recall@k and NDCG@k of the targets' 0-based positions (JAX
    `quick_start.py:357-363`)."""
    out = {}
    for k in ks:
        hit = pos < k
        out[f"Recall(k={k})"] = float(hit.mean())
        gains = 1.0 / np.log2(np.maximum(pos, 0) + 2.0)
        out[f"NDCG(k={k})"] = float(np.where(hit, gains, 0.0).mean())
    return out


def run_sequential_experiment(
    config: Mapping[str, Any],
    feature_map: FeatureMap,
    train_arrays: Dict[str, np.ndarray],
    valid_arrays: Dict[str, np.ndarray],
    test_arrays: Optional[Dict[str, np.ndarray]] = None,
    ks=(10, 20),
    mesh=None,
    device: Device = None,
) -> Dict[str, float]:
    """Next-item pipeline (recbole's sequential protocol): leave-one-out
    arrays from `data.sequential`, full-softmax CE (through B2 where
    `_use_fused_ce` opens), Recall / NDCG@k of the held-out target under
    ``eval_protocol`` 'full' (the whole catalog) or 'uniN' / 'popN' (N
    sampled negatives outside the row's history). The scores are taken in
    chunks of ``eval_batch_size`` rows and ranked on the device; the
    best-valid weights give the ``test_*`` keys."""
    config = Config(config)
    dev = resolve_device(device)
    model, _ = build_model(config, feature_map, dev)
    protocol = config.get("eval_protocol", "full")
    if protocol != "full":
        from recbox_tpu_torch.evaluation.candidate import parse_protocol
        parse_protocol(protocol)          # a bad spelling fails here
    corpus = feature_map.corpus_index
    cand_cache: Dict[int, np.ndarray] = {}

    def eval_split(trainer, split, split_id):
        if protocol != "full" and split_id not in cand_cache:
            cand_cache[split_id] = _eval_candidates(
                protocol, split, feature_map, train_arrays[corpus], config)
        bs = config.get("eval_batch_size", 4096)
        keys = [k for k in ("item_seq", "seq_len", "user_id") if k in split]
        n = len(split[corpus])
        pos = []
        for s in range(0, n, bs):
            scores = trainer.apply({k: split[k][s:s + bs] for k in keys},
                                   method="full_scores")
            tgt = torch.as_tensor(split[corpus][s:s + bs].astype(np.int64),
                                  device=trainer.device)
            cand = None if protocol == "full" else torch.as_tensor(
                cand_cache[split_id][s:s + bs], device=trainer.device)
            pos.append(hit_positions(scores, tgt, cand))
        return rank_metrics(torch.cat(pos).cpu().numpy(), ks)

    def eval_valid(trainer):
        # under a mesh every rank ranks the whole split (its rows of the
        # sharded logits): the merge weighs the ranks alike
        eval_valid.last_sample_count = float(len(valid_arrays[corpus]))
        return eval_split(trainer, valid_arrays, 0)

    use_fused = _use_fused_ce(config, feature_map, model, mesh)
    if use_fused:
        logger.info("sequential CE: flash-CE kernel path (%d items)",
                    feature_map[corpus].vocab_size)
    trainer = Trainer(
        model,
        (lambda o, b: o) if use_fused else
        (lambda o, b: full_softmax_loss(o, b[corpus])),
        build_trainer_config(config),
        eval_fn=eval_valid,
        mesh=mesh, device=dev,
        train_method="fused_ce_loss" if use_fused else "full_scores")
    loader = ArrayLoader(train_arrays,
                         batch_size=config.get("batch_size", 2048),
                         drop_last=True, seed=config.get("seed", 2024))
    result = trainer.fit(loader, epochs=config.get("epochs"))
    if test_arrays is not None:
        result = {**result, **{f"test_{k}": v for k, v in
                               eval_split(trainer, test_arrays, 1).items()}}
    logger.info("experiment %s: %s", config.get("experiment_id", "?"), result)
    return result


def run_kg_experiment(
    config: Mapping[str, Any],
    feature_map: FeatureMap,
    train_arrays: Dict[str, np.ndarray],
    corpus_arrays: Dict[str, np.ndarray],
    kg,
    eval_user_arrays: Dict[str, np.ndarray],
    query_indices: np.ndarray,
    train_user2items: Mapping[int, Any],
    valid_user2items: Mapping[int, Any],
    mesh=None,
    device: Device = None,
) -> Dict[str, float]:
    """Knowledge-enhanced retrieval (recbole's KGTrainer protocol): each
    epoch runs a CF phase (the pairwise loss over `MatchingLoader`'s
    sampled negatives) and then, for a model with ``kg_loss``, a KG phase
    of ``kg_steps_per_epoch`` steps (default: the CF epoch's length) over
    ``kg_batch_size`` (512) triples with corrupted tails, under an Adam of
    its own at ``kg_learning_rate`` (default: learning_rate); then the
    retrieval evaluation, best-weight capture and early stop of `Trainer`.

    ``kg`` is a `data.knowledge.KnowledgeGraph`. The KG batches are drawn
    from ``default_rng(seed + 7)``, JAX's draws in JAX's order (one batch
    goes to JAX's initialisation of the KG heads first, and is drawn and
    dropped here). Under a mesh every rank draws the same batch and passes
    it as its rows, as the CF phase passes the loader's: the global batch
    is n_data copies of it, and the KG step takes the trainer's mesh step
    (`Trainer._mesh_loss` scales the loss by 1 / n_data, the replicated
    gradients are summed over 'data'), so the drawn batch counts once,
    JAX's one mean over one replicated batch."""
    config = Config(config)
    dev = resolve_device(device)
    model, _ = build_model(config, feature_map, dev)
    metrics = list(config.get("metrics", ["Recall(k=20)", "NDCG(k=10)"]))
    evaluator = RetrievalEvaluator(
        eval_user_arrays, corpus_arrays, query_indices, train_user2items,
        valid_user2items, metrics=metrics,
        batch_size=config.get("eval_batch_size", 4096),
        protocol=config.get("eval_protocol", "full"),
        protocol_seed=config.get("seed", 2024),
        exclude_items=tuple(config.get("exclude_items", ())))
    match_loss = get_matching_loss(config.get("loss",
                                              "PairwiseLogisticLoss"))
    trainer = Trainer(model, lambda out, b: match_loss(out),
                      build_trainer_config(config), eval_fn=evaluator,
                      mesh=mesh, device=dev)
    loader = MatchingLoader(
        feature_map, train_arrays, corpus_arrays,
        batch_size=config.get("batch_size", 2048),
        num_negs=config.get("num_negs", 1), seed=config.get("seed", 2024),
        exclude_ids=tuple(config.get("exclude_items", ())))
    # JAX initialises from the loader's first batch, which moves the
    # loader's generator by one epoch
    trainer.init(next(iter(loader)))

    np_rng = np.random.default_rng(config.get("seed", 2024) + 7)
    kg_bs = config.get("kg_batch_size", 512)

    def kg_batch():
        idx = np_rng.integers(0, kg.n_triples, size=kg_bs)
        arrays = {"kg_head": kg.heads[idx], "kg_relation": kg.relations[idx],
                  "kg_tail": kg.tails[idx],
                  "kg_neg_tail": np_rng.integers(0, kg.n_entities,
                                                 size=kg_bs)}
        return {k: torch.as_tensor(np.asarray(v)).to(dev)
                for k, v in arrays.items()}

    kg_step = None
    if hasattr(model, "kg_loss"):
        kg_batch()   # JAX's model.init(..., kg_batch(), method=kg_loss)
        params = list(trainer.params.values())
        kg_opt = _ForeachAdam(params, config.get(
            "kg_learning_rate", config.get("learning_rate", 1e-3)),
            max_norm=None)

        def kg_step():
            model.eval()     # JAX applies kg_loss with train=False
            objective, loss = trainer._mesh_loss(model.kg_loss(kg_batch()))
            grads = torch.autograd.grad(objective, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            if mesh is not None:
                trainer._reduce_dense_grads(grads)
            kg_opt.step(grads)
            return loss.detach()

    result: Dict[str, float] = {}
    kg_steps = config.get("kg_steps_per_epoch", len(loader))
    for epoch in range(config.get("epochs", 10)):
        trainer.epoch = epoch
        for batch in loader:
            trainer.train_step(batch)
        if kg_step is not None:
            kg_losses = [kg_step() for _ in range(kg_steps)]
            logger.info("kg phase epoch %d: loss %.4f", epoch,
                        float(torch.stack(kg_losses).mean()))
        result = trainer._evaluate_and_checkpoint()
        if trainer._stopped:
            break
    trainer._restore_best()
    logger.info("kg experiment %s: %s", config.get("experiment_id", "?"),
                result)
    return result


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


def run_experiment(
    model: str,
    dataset: str,
    config: Optional[Mapping[str, Any]] = None,
    data_dir: Optional[str] = None,
    mesh=None,
    device: Device = None,
    **overrides,
) -> Dict[str, float]:
    """One call from a dataset NAME to trained and evaluated metrics (the
    `run_recbole(model, dataset)` analog): acquire the atomic files by name
    (`data/acquire.py`), load, filter, remap contiguously, split, then the
    stage's pipeline. Returns the best-valid metrics, plus ``test_*``
    where the stage evaluates a test split.

    Config / overrides, as JAX's (`quick_start.py:647-700`): dataset_url /
    dataset_sha256; user_field / item_field / rating_field / time_field;
    min_rating; min_user_inter / min_item_inter (k-core); split 'RS'
    (default) or 'LS' (leave-one-out; not the ranking stage);
    split_ratios (0.8, 0.1, 0.1); order 'TO' or 'RO' (default 'TO' when
    timestamps exist, else 'RO'; the ranking stage defaults to 'RO');
    binarize_threshold (ranking labels); max_seq_len (50); embedding_dim
    (64); topk (sequential, (10, 20)); everything else passes through to
    the pipeline and the model. Multitask and reranking models raise (a
    single .inter file cannot express their supervision). A knowledge
    model's items and KG entities are filtered and remapped jointly, and
    ``n_entities``, ``n_relations``, ``num_users`` and ``num_items`` come
    from the loaded graph unless the config pins them."""
    from recbox_tpu_torch.features.schema import FeatureSpec

    dev = resolve_device(device)
    cfg = dict(config or {})
    cfg.update(overrides)
    cfg["model"] = model
    cfg.setdefault("experiment_id", f"{model}-{dataset}")
    _, stage = get_model(model)
    if stage in ("multitask", "reranking"):
        raise NotImplementedError(
            f"model {model!r} is stage {stage!r}: a single .inter file "
            "cannot express its supervision (multiple labels / slates) — "
            f"use quick_start.run_{'ranking' if stage == 'multitask' else 'rerank'}"
            "_experiment with explicit arrays.")
    ds, inter, rf, tf = _acquire_interactions(dataset, cfg, data_dir)
    if stage == "knowledge":
        # the KG's entities are the items' ids: filter, then remap items
        # and entities jointly (recbole's filter-then-remap); without a
        # filter the loaded ids stand
        if (cfg.get("min_rating") is not None or cfg.get("min_user_inter")
                or cfg.get("min_item_inter")):
            uf = cfg.get("user_field", "user_id")
            itf = cfg.get("item_field", "item_id")
            ds = ds.filter_interactions(
                min_rating=(None if cfg.get("min_rating") is None
                            else float(cfg["min_rating"])),
                min_user_inter=int(cfg.get("min_user_inter", 0) or 0),
                min_item_inter=int(cfg.get("min_item_inter", 0) or 0),
                rating_field=rf or "rating", user_field=uf, item_field=itf)
            inter = ds.to_interactions(user_field=uf, item_field=itf,
                                       rating_field=rf, time_field=tf)
    else:
        inter = _filter_and_remap(inter, cfg)
    n_users, n_items = inter.num_users, inter.num_items
    seed = cfg.get("seed", 2024)
    emb_dim = cfg.get("embedding_dim", 64)
    order = cfg.get("order", "TO" if inter.timestamps is not None else "RO")

    if stage == "sequential":
        from recbox_tpu_torch.data.sequential import (
            group_user_sequences, leave_one_out_split,
        )
        seqs = group_user_sequences(inter.user_ids, inter.item_ids,
                                    inter.timestamps)
        train, valid, test = leave_one_out_split(
            seqs, max_len=cfg.get("max_seq_len", 50))
        fm = FeatureMap(dataset, (
            FeatureSpec("item_id", "categorical", source="item",
                        vocab_size=n_items, embedding_dim=emb_dim),),
            query_index="user_id", corpus_index="item_id",
            num_items=n_items)
        ks = cfg.get("topk", (10, 20))
        ks = (int(ks),) if isinstance(ks, int) else tuple(ks)
        return run_sequential_experiment(cfg, fm, train, valid,
                                         test_arrays=test, ks=ks, mesh=mesh,
                                         device=dev)

    if stage == "ranking":
        if rf is None:
            raise ValueError(
                f"CTR model {model!r} needs a rating/label column in "
                f"{dataset}.inter (set rating_field=) to derive labels")
        vals = np.unique(inter.ratings)
        if cfg.get("binarize_threshold") is not None:
            inter = inter.binarize(float(cfg["binarize_threshold"]))
        elif not np.isin(vals, (0.0, 1.0)).all():
            raise ValueError(
                f"{dataset!r} ratings take values {vals[:8]}... — set "
                "binarize_threshold (recbole's label-by-threshold, e.g. 4.0 "
                "for 1-5 star scales) to derive a binary CTR label")
        arrays = {"user_id": inter.user_ids.astype(np.int32),
                  "item_id": inter.item_ids.astype(np.int32),
                  "label": inter.ratings.astype(np.float32)}
        if cfg.get("split", "RS") != "RS":
            raise NotImplementedError(
                "ranking stage uses row-wise RS splits (recbole CTR "
                "protocol); leave-one-out has no meaning for pointwise "
                "labels")
        n = len(inter)
        if cfg.get("order", "RO") == "TO":
            if inter.timestamps is None:
                raise ValueError("order='TO' needs a timestamp column")
            idx = np.argsort(inter.timestamps, kind="mergesort")
        else:
            idx = np.random.default_rng(seed).permutation(n)
        ratios = tuple(cfg.get("split_ratios", (0.8, 0.1, 0.1)))
        c1 = n - int(ratios[1] * n) - int(ratios[2] * n)
        c2 = n - int(ratios[2] * n)
        tr, va, te = idx[:c1], idx[c1:c2], idx[c2:]
        fm = FeatureMap(dataset, (
            FeatureSpec("user_id", "categorical", source="user",
                        vocab_size=n_users, embedding_dim=emb_dim),
            FeatureSpec("item_id", "categorical", source="item",
                        vocab_size=n_items, embedding_dim=emb_dim)),
            labels=("label",))

        def sel(rows):
            return {k: v[rows] for k, v in arrays.items()}

        return run_ranking_experiment(
            cfg, fm, sel(tr), sel(va),
            test_arrays=sel(te) if len(te) else None, mesh=mesh, device=dev)

    # matching / traditional / knowledge: interaction splits + retrieval
    # evaluation
    if cfg.get("split", "RS") == "LS":
        train, valid, test = inter.split_leave_one_out(
            order=order if inter.timestamps is not None else "RO", seed=seed)
    else:
        train, valid, test = inter.split_ratio(
            tuple(cfg.get("split_ratios", (0.8, 0.1, 0.1))), order=order,
            group_by_user=True, seed=seed)
    train_u2i, valid_u2i, test_u2i = map(_user2items, (train, valid, test))
    if not valid_u2i:
        raise ValueError(
            f"dataset {dataset!r}: the valid split is EMPTY after "
            f"filtering/splitting ({len(train)} train rows) — per-user "
            "ratio splits floor(n*ratio) each part, so users need enough "
            "interactions (>= 10 at the default 0.8/0.1/0.1) or use "
            "split='LS' (leave-one-out)")
    exclude = tuple(cfg.get("exclude_items", (0,)))   # the PAD / OOV row
    cfg.setdefault("exclude_items", list(exclude))
    metrics = list(cfg.get("metrics", ["Recall(k=20)", "NDCG(k=10)"]))

    if stage == "traditional":
        return _run_traditional(cfg, model, train, valid_u2i, test_u2i,
                                train_u2i, n_users, n_items, exclude,
                                metrics, dev)

    fm = FeatureMap(dataset, (
        FeatureSpec("user_id", "categorical", source="user",
                    vocab_size=n_users, embedding_dim=emb_dim),
        FeatureSpec("item_id", "categorical", source="item",
                    vocab_size=n_items, embedding_dim=emb_dim)),
        query_index="user_id", corpus_index="item_id", num_items=n_items)
    vu = np.asarray(sorted(valid_u2i), dtype=np.int64)
    train_arrays = {"user_id": train.user_ids.astype(np.int32),
                    "item_id": train.item_ids.astype(np.int32)}
    corpus_arrays = {"item_id": np.arange(n_items, dtype=np.int32)}
    eval_user_arrays = {"user_id": vu.astype(np.int32)}
    if stage == "knowledge":
        kg = ds.to_knowledge_graph()
        cfg.setdefault("n_entities", kg.n_entities)
        cfg.setdefault("n_relations", kg.n_relations)
        cfg.setdefault("num_users", n_users)
        cfg.setdefault("num_items", n_items)
        return run_kg_experiment(
            cfg, fm, train_arrays, corpus_arrays, kg, eval_user_arrays, vu,
            train_u2i, valid_u2i, mesh=mesh, device=dev)
    return run_matching_experiment(
        cfg, fm, train_arrays, corpus_arrays, eval_user_arrays, vu,
        train_u2i, valid_u2i, mesh=mesh,
        test_user2items=test_u2i or None, device=dev)


def _run_traditional(cfg, model, train, valid_u2i, test_u2i, train_u2i,
                     n_users, n_items, exclude, metrics, dev):
    """The closed-form / neighbourhood route of `run_experiment` (JAX
    :800-830): ``fit(user_ids, item_ids)``, then full-sort evaluation of
    ``full_scores`` in chunks of 4096 users with the known positives and
    ``exclude`` masked."""
    from recbox_tpu_torch.evaluation.retrieval import (
        _pad_lists, parse_metric, retrieval_metrics_from_topk,
    )
    cls, _ = get_model(model)
    accepted = set(inspect.signature(cls.__init__).parameters) - {
        "self", "device"}
    m = cls(**{k: v for k, v in cfg.items() if k in accepted}, device=dev)
    m.fit(train.user_ids, train.item_ids, n_users, n_items)
    max_topk = max(parse_metric(s)[1] for s in metrics)

    def evaluate(u2i_truth, u2i_masks):
        q = np.asarray(sorted(u2i_truth), dtype=np.int64)
        out: Dict[str, float] = {}
        for s in range(0, len(q), 4096):
            qs = q[s:s + 4096]
            scores = _numpy(m.full_scores(qs)).copy()
            for r, u in enumerate(qs):
                for mask in u2i_masks:
                    scores[r, list(mask.get(int(u), ()))] = -np.inf
                scores[r, list(exclude)] = -np.inf
            topk = np.argsort(-scores, axis=1)[:, :max_topk]
            true_p = _pad_lists(
                [list(dict.fromkeys(u2i_truth.get(int(u), ())))
                 for u in qs], pad=-1)
            vals = retrieval_metrics_from_topk(topk, true_p, metrics,
                                               device=dev)
            for k, v in vals.items():
                out[k] = out.get(k, 0.0) + v * len(qs)
        return {k: v / max(len(q), 1) for k, v in out.items()}

    result = evaluate(valid_u2i, (train_u2i,))
    result.update({f"test_{k}": v for k, v in
                   evaluate(test_u2i, (train_u2i, valid_u2i)).items()})
    logger.info("experiment %s: %s", cfg["experiment_id"], result)
    return result


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
