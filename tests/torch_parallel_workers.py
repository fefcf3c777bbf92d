"""Rank processes for the port's multi-rank CPU tests (not collected).

`run(task, world, tmp_path, **kwargs)` starts ``world`` gloo processes with
`torch.multiprocessing.spawn`; they meet through a ``file://`` store under
``tmp_path`` (no ports to collide between test workers), each runs
``task(rank, world, **kwargs)`` with one thread, and each returns its
arrays to the parent through an npz (``{name: array}``; a task may also
return nothing). This module imports the port only, never JAX: the JAX
side of each comparison runs in the test process.
"""

from __future__ import annotations

import os
import traceback
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from recbox_tpu_torch.features import FeatureMap, FeatureSpec
from recbox_tpu_torch.models.ranking import DeepFM
from recbox_tpu_torch.ops.losses import binary_crossentropy
from recbox_tpu_torch.parallel import make_mesh
from recbox_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, mesh_coords, mesh_shape,
)
from recbox_tpu_torch.parallel.inspect import collective_stats
from recbox_tpu_torch.training import (
    PackedEmbeddingTrainer, SparseEmbeddingTrainer, Trainer, TrainerConfig,
)
from recbox_tpu_torch.training.sparse import merge_params


def run(task: str, world: int, tmp_path, **kwargs) -> List[Dict]:
    """Each rank's arrays, in rank order."""
    tmp = str(tmp_path)
    rdv = os.path.join(tmp, f"rdv_{task}")
    if os.path.exists(rdv):
        os.remove(rdv)
    mp.spawn(_entry, args=(world, rdv, task, kwargs, tmp), nprocs=world,
             join=True)
    out = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"{task}_rank{r}.npz"),
                     allow_pickle=False) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _entry(rank, world, rdv, task, kwargs, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        res = globals()[task](rank, world, **kwargs) or {}
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(tmp, f"{task}_rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})


# -- DeepFM over a small schema (JAX's `tests/test_parallel.py` shapes) ---------

def feature_map(S, FM, vocab=64, dim=16, shard=(None, None),
                names=("cat_a", "cat_b")):
    """Two categorical fields (either package's FeatureSpec / FeatureMap),
    with their ``shard_table`` placements."""
    return FM("p", tuple(
        S(n, "categorical", vocab_size=v, embedding_dim=dim, shard_table=s)
        for n, v, s in zip(names, vocab if isinstance(vocab, tuple)
                           else (vocab, vocab), shard)), labels=("click",))


def deepfm(state_path=None, vocab=64, dim=16, hidden=(16,),
           shard=(None, None)):
    """The port's DeepFM over `feature_map`, with a saved state."""
    fm = feature_map(FeatureSpec, FeatureMap, vocab, dim, shard)
    model = DeepFM(fm, embedding_dim=dim, hidden_units=hidden, device="cpu")
    if state_path is not None:
        model.load_state_dict(torch.load(state_path, weights_only=True))
    return model


def local_rows(batch: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """This rank's rows of a global batch: its 'data' shard."""
    nd = mesh_shape(mesh)[DATA_AXIS]
    d = mesh_coords(mesh)[0]
    n = len(next(iter(batch.values()))) // nd
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


KINDS = {"dense": Trainer, "packed": PackedEmbeddingTrainer,
         "sparse": SparseEmbeddingTrainer,
         "sparse-mixed": SparseEmbeddingTrainer}
# each kind's `shard_table` placements: 'sparse-mixed' replicates cat_a's
# tables (what `placement.apply_placement` writes for a small table)
PLACEMENTS = {"sparse-mixed": (False, None)}


def make_trainer(kind, model, mesh, lr=1e-2, **cfg):
    return KINDS[kind](model, lambda o, b: binary_crossentropy(o, b["click"]),
                       TrainerConfig(learning_rate=lr, epochs=1,
                                     monitor="AUC", seed=5, **cfg),
                       mesh=mesh, device="cpu")


def whole_params(trainer) -> Dict[str, np.ndarray]:
    """The whole model's parameters by port name, tables gathered (a
    collective: every rank calls it)."""
    if isinstance(trainer, PackedEmbeddingTrainer):
        params = trainer.full_params()
    elif isinstance(trainer, SparseEmbeddingTrainer):
        state = trainer.state_dict()
        params = merge_params(state["params"], state["tables"],
                              {k: h for k, h in _homes(trainer).items()})
    else:
        params = trainer.state_dict()["params"]
    return {k: v.detach().numpy().copy() for k, v in params.items()}


def _homes(trainer):
    from recbox_tpu_torch.training.sparse import split_sparse_params
    return split_sparse_params(trainer.model)[2]


def trainer_steps(rank, world, state_path, batch_path, meshes, kinds,
                  steps=3):
    """For each mesh shape (n_model) and trainer kind: ``steps`` steps of
    one global batch from the saved state; the losses and the whole
    tables / parameters after them."""
    with np.load(batch_path) as z:
        batch = {k: z[k] for k in z.files}
    out = {}
    for m in meshes:
        mesh = make_mesh(m, device="cpu")
        mine = local_rows(batch, mesh)
        for kind in kinds:
            t = make_trainer(kind, deepfm(
                state_path, shard=PLACEMENTS.get(kind, (None, None))), mesh)
            t.init(mine)
            losses = [float(t.train_step(dict(mine))) for _ in range(steps)]
            out[f"{kind}/m{m}/loss"] = np.asarray(losses)
            for k, v in whole_params(t).items():
                out[f"{kind}/m{m}/{k}"] = v
            if kind == "dense":
                name = "embedding.tables.cat_a"
                out[f"{kind}/m{m}/local_shape"] = np.asarray(
                    t.params[name].shape)
                out[f"{kind}/m{m}/spec"] = np.asarray(
                    [str(t.param_specs[name])])
    return out


def comm_bytes(rank, world, cases, vocab, small, batch_rows, dim, hidden):
    """Per case (placement, n_model): the collective bytes one dense
    `Trainer` step issues on this rank (after a first step, which also
    checks the batch), and the dense parameter count outside the tables."""
    rng = np.random.default_rng(0)
    b = {"big": rng.integers(0, vocab, batch_rows).astype(np.int32),
         "small": rng.integers(0, small, batch_rows).astype(np.int32),
         "click": (rng.random(batch_rows) > 0.5).astype(np.float32)}
    out = {}
    for placement, m in cases:
        shard = {"sharded": (True, True), "mixed": (True, False),
                 "replicated": (False, False)}[placement]
        fm = feature_map(FeatureSpec, FeatureMap, (vocab, small), dim,
                         shard, names=("big", "small"))
        model = DeepFM(fm, embedding_dim=dim, hidden_units=hidden,
                       device="cpu")
        mesh = make_mesh(m, device="cpu")
        mine = local_rows(b, mesh)
        t = make_trainer("dense", model, mesh)
        t.init(mine)
        t.train_step(dict(mine))
        ops = collective_stats(t.train_step, dict(mine))
        dense = sum(p.numel() for n, p in model.named_parameters()
                    if ".tables." not in n)
        out[f"{placement}/m{m}/bytes"] = np.asarray(
            sum(op.bytes for op in ops))
        out[f"{placement}/m{m}/dense"] = np.asarray(dense)
        out[f"{placement}/m{m}/kinds"] = np.asarray(
            sorted({op.kind for op in ops}) or [""])
    return out


def fused_and_errors(rank, world, state_path, batch_path):
    """`train_steps_fused` under a mesh against two `train_step` calls
    from the same state; `make_mesh`'s and `shard_batch`'s refusals."""
    from recbox_tpu_torch.parallel.mesh import shard_batch
    with np.load(batch_path) as z:
        batch = {k: z[k] for k in z.files}
    mesh = make_mesh(2, device="cpu")
    mine = local_rows(batch, mesh)
    out = {"mesh_shape": np.asarray([mesh_shape(mesh)[DATA_AXIS],
                                     mesh_shape(mesh)[MODEL_AXIS]])}
    t1 = make_trainer("dense", deepfm(state_path), mesh, fused_steps=2)
    t1.init(mine)
    fused = t1.train_steps_fused({k: np.stack([v, v])
                                  for k, v in mine.items()})
    t2 = make_trainer("dense", deepfm(state_path), mesh)
    t2.init(mine)
    eager = [float(t2.train_step(dict(mine))) for _ in range(2)]
    out["fused"] = fused.numpy()
    out["eager"] = np.asarray(eager)
    out["fused_step"] = np.asarray(t1.step)
    try:
        make_mesh(3, device="cpu")
        out["undivisible_raised"] = np.asarray(False)
    except ValueError:
        out["undivisible_raised"] = np.asarray(True)
    # a rank on the other 'model' coordinate with different rows
    other = {k: (v + 1 if k == "cat_a" and mesh_coords(mesh)[1] == 1
                 else v) for k, v in mine.items()}
    try:
        shard_batch(other, mesh)
        out["mismatch_raised"] = np.asarray(False)
    except ValueError:
        out["mismatch_raised"] = np.asarray(True)
    return out


def multihost(rank, world, ckpt, data_dir, orbax_dir):
    """JAX's `tests/test_multihost.py` on two ranks: the rank-0 checkpoint,
    the metric merge, `Trainer`'s merged evaluation, `shard_batch`, the
    rank-0 `acquire_dataset`, and an `OrbaxCheckpointer` round trip."""
    import logging
    from recbox_tpu_torch.data import acquire
    from recbox_tpu_torch.models.ranking import LR
    from recbox_tpu_torch.parallel.distributed import (
        merge_host_metrics, process_info,
    )
    from recbox_tpu_torch.parallel.mesh import all_gather, barrier
    from recbox_tpu_torch.parallel.mesh import shard_batch
    from recbox_tpu_torch.training.checkpoint import (
        OrbaxCheckpointer, load_checkpoint, save_checkpoint,
    )
    out = {"process_count": process_info()["process_count"]}
    # 1. every rank calls save; rank 1 first, and no file may appear
    state = {"x": torch.full((4,), 7.0), "rank_of_writer": torch.tensor(rank)}
    if rank == 1:
        save_checkpoint(ckpt, state)
    barrier()
    out["rank1_wrote"] = os.path.exists(ckpt)
    barrier()
    if rank == 0:
        save_checkpoint(ckpt, state)
    barrier()
    out["writer"] = int(load_checkpoint(ckpt)["rank_of_writer"])
    out["tmp_left"] = os.path.exists(ckpt + ".tmp")
    # 2. the weighted mean over ranks; a rank of weight 0 (NaN metrics)
    # contributes exact zeros
    out["merged"] = merge_host_metrics({"AUC": 1.0 if rank == 0 else 0.0},
                                       1.0 if rank == 0 else 3.0)["AUC"]
    out["merged_empty"] = merge_host_metrics(
        {"AUC": 0.5 if rank == 0 else float("nan")},
        2.0 if rank == 0 else 0.0)["AUC"]
    # 3. Trainer's evaluation merges each rank's shard metrics
    fm = FeatureMap("mh", (FeatureSpec("a", "categorical", vocab_size=8,
                                       embedding_dim=4),), labels=("y",))
    t = Trainer(LR(fm, device="cpu"),
                lambda o, b: binary_crossentropy(o, b["y"]),
                TrainerConfig(learning_rate=1e-2, monitor="AUC"),
                device="cpu")
    t.init({"a": np.array([1, 2], np.int32),
            "y": np.array([1., 0.], np.float32)})

    class ShardEval:
        def __call__(self, tr):
            self.last_sample_count = 2.0 if rank == 0 else 6.0
            return {"AUC": 0.9 if rank == 0 else 0.5}

    t.eval_fn = ShardEval()
    out["trainer_merged"] = t._evaluate_and_checkpoint()["AUC"]
    records = []

    class Catch(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logging.getLogger("recbox_tpu_torch").addHandler(Catch())
    t.eval_fn = lambda tr: {"AUC": 0.9 if rank == 0 else 0.5}
    out["unweighted"] = t._evaluate_and_checkpoint()["AUC"]
    out["warned"] = any("last_sample_count" in m for m in records)
    # 4. the global batch is the union of the ranks' local rows
    mesh = make_mesh(1, device="cpu")
    local = np.arange(4, dtype=np.float32) + (0.0 if rank == 0 else 10.0)
    mine = shard_batch({"x": local}, mesh)["x"]
    whole = all_gather(mine, mesh, DATA_AXIS)
    out["global_rows"] = whole.numel()
    out["global_sum"] = float(whole.sum())
    # 5. rank 0 extracts a staged archive while rank 1 waits; rank 1 never
    # fetches or extracts
    if rank == 1:
        def refuse(*a, **k):
            raise AssertionError("rank 1 must not download or extract")
        acquire.download_url = acquire.extract_archive = refuse
    folder = acquire.acquire_dataset(
        "mhds", data_dir, url="file:///nonexistent/mhds.zip")
    out["inter_seen"] = os.path.exists(os.path.join(folder, "mhds.inter"))
    # 6. an asynchronous sharded save, its wait, and a load into a fresh
    # trainer's template
    rng = np.random.default_rng(3)
    b = {"cat_a": rng.integers(0, 63, 32).astype(np.int32),
         "cat_b": rng.integers(0, 63, 32).astype(np.int32),
         "click": (rng.random(32) > 0.5).astype(np.float32)}
    for kind in ("dense", "packed"):
        torch.manual_seed(0)
        t1 = make_trainer(kind, deepfm(vocab=63), mesh)
        mine = local_rows(b, mesh)
        t1.init(mine)
        t1.train_step(dict(mine))
        ck = OrbaxCheckpointer()
        ck.save(os.path.join(orbax_dir, kind), t1.state_dict(sharded=True))
        t1.train_step(dict(mine))          # training goes on meanwhile
        ck.wait()
        saved_meta = os.path.exists(os.path.join(orbax_dir,
                                                 kind + ".meta/state.json"))
        torch.manual_seed(1)
        t2 = make_trainer(kind, deepfm(vocab=63), mesh)
        t2.init(mine)
        got = ck.load(os.path.join(orbax_dir, kind),
                      t2.state_dict(sharded=True))
        t2.load_state_dict(got)
        # t1 stepped once more after the save: step it back with t2's
        # second step and compare the gathered states
        t2.train_step(dict(mine))
        a, c = t1.state_dict(), t2.state_dict()
        out[f"orbax_{kind}_step"] = c["step"]
        out[f"orbax_{kind}_meta"] = saved_meta
        out[f"orbax_{kind}_equal"] = all(
            torch.equal(a["params"][k], c["params"][k]) for k in a["params"])
        if kind == "packed":
            out["orbax_packed_equal"] = out["orbax_packed_equal"] and all(
                torch.equal(a["packs"][k], c["packs"][k])
                for k in a["packs"])
    return out


def sharded_search(rank, world, cases, service_dir):
    """Each case's sharded search ({name: (items path, n_model, topk,
    method, bf16)}): every rank's (scores, ids); a `RetrievalService` on the
    mesh, saved by rank 0 and loaded again; and the int8 index's refusal of
    a mesh."""
    from recbox_tpu_torch.retrieval import BruteForceMIPS
    out = {}
    meshes = {}
    for name, (path, m, topk, method, bf16) in sorted(cases.items()):
        if m not in meshes:
            meshes[m] = make_mesh(m, device="cpu")
        with np.load(path) as z:
            items, queries = z["items"], z["queries"]
        index = BruteForceMIPS(items, mesh=meshes[m], method=method,
                               bf16=bf16)
        s, i = index.search(queries, topk)
        out[f"{name}/scores"] = s.numpy()
        out[f"{name}/ids"] = i.numpy()
        out[f"{name}/shard_rows"] = np.asarray(index.items.shape[0])
    out.update(_service_on_mesh(meshes[max(meshes)], service_dir))
    try:
        BruteForceMIPS(np.ones((8, 4), np.float32), mesh=meshes[max(meshes)],
                       quantize="int8")
        out["int8_refused"] = np.asarray(False)
    except NotImplementedError:
        out["int8_refused"] = np.asarray(True)
    return out


def _service_on_mesh(mesh, path):
    """MF's service with its index sharded over 'model': the queries of 8
    users, the same from a saved and reloaded service and from an
    unsharded index; only rank 0 writes."""
    from recbox_tpu_torch.models.matching import MF
    from recbox_tpu_torch.parallel.mesh import rank
    from recbox_tpu_torch.retrieval import RetrievalService
    fm = FeatureMap("svc", (
        FeatureSpec("user_id", "categorical", source="user", vocab_size=64,
                    embedding_dim=8),
        FeatureSpec("item_id", "categorical", source="item", vocab_size=203,
                    embedding_dim=8)),
        query_index="user_id", corpus_index="item_id", num_items=203)
    torch.manual_seed(7)
    model = MF(fm, embedding_dim=8, device="cpu")
    corpus = {"item_id": np.arange(203, dtype=np.int32)}
    users = {"user_id": np.arange(8, dtype=np.int32)}
    svc = RetrievalService(model, corpus, method="exact_sort", mesh=mesh,
                           device="cpu")
    s, i = svc.query(users, k=10)
    plain = RetrievalService(model, corpus, method="exact_sort",
                             device="cpu")
    ps, pi = plain.query(users, k=10)
    if rank() == 1:
        svc.save(path)                 # rank 1 first: nothing may appear
    _barrier()
    written_by_1 = os.path.exists(os.path.join(path, "service.json"))
    _barrier()
    svc.save(path)
    _barrier()
    torch.manual_seed(8)
    again = RetrievalService.load(path, MF(fm, embedding_dim=8,
                                           device="cpu"), mesh=mesh)
    ls, li = again.query(users, k=10)
    return {"svc/scores": s, "svc/ids": i, "svc/plain_scores": ps,
            "svc/plain_ids": pi, "svc/loaded_ids": li,
            "svc/loaded_scores": ls, "svc/rank1_wrote": written_by_1,
            "svc/index_rows": svc.index.items.shape[0]}


def _barrier():
    from recbox_tpu_torch.parallel.mesh import barrier
    barrier()


LAYOUTS = {"lazy_adam": (16, dict(embedding_optimizer="adam")),
           "block_rows": (16, dict(block_rows=True)),
           "split_accumulators": (127, {})}


def packed_layout(name, state_path, mesh=None):
    """The packed trainer in one of its other layouts (JAX
    `packed.py:203-279`): lazy Adam, block rows, or split accumulators
    (127 + 1 value columns fill the 128-lane pad)."""
    dim, kw = LAYOUTS[name]
    model = deepfm(state_path, dim=dim)
    return PackedEmbeddingTrainer(
        model, lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(learning_rate=1e-2, epochs=1, monitor="AUC", seed=5),
        mesh=mesh, device="cpu", **kw)


def packed_layouts(rank, world, states, batch_path, m=2):
    """Each layout under a mesh of n_model ``m``: 3 steps, the losses,
    the whole tables and accumulators."""
    with np.load(batch_path) as z:
        batch = {k: z[k] for k in z.files}
    mesh = make_mesh(m, device="cpu")
    mine = local_rows(batch, mesh)
    out = {}
    for name in LAYOUTS:
        t = packed_layout(name, states[name], mesh)
        t.init(mine)
        out[f"{name}/loss"] = np.asarray(
            [float(t.train_step(dict(mine))) for _ in range(3)])
        for k, v in t.tables.items():
            out[f"{name}/table/{k}"] = v.numpy().copy()
        for k, v in t.accumulators.items():
            out[f"{name}/acc/{k}"] = v.numpy().copy()
        out[f"{name}/split"] = np.asarray(bool(t.accs))
        out[f"{name}/block"] = np.asarray(any(t._block_mode.values()))
    return out


# -- a model's own row-sharded tables (`test_torch_mesh_tables`) ---------------

MT_V, MT_D, MT_L, MT_B, MT_USERS, MT_NEGS = 64, 16, 8, 32, 16, 3
# name: (module of `recbox_tpu_torch.models`, constructor keywords, the
# trainer's train_method); the sequential models train on the full
# softmax, NeuMF and MIND on (B, 1 + negs) sampled candidates
MT_CASES = {
    "SASRec": ("sequential", dict(n_layers=1, n_heads=2), "full_scores"),
    "CORE": ("sequential", dict(n_layers=1, n_heads=2), "full_scores"),
    "SRGNN": ("sequential", dict(steps=1), "full_scores"),
    "NeuMF": ("matching", dict(mlp_hidden_units=(16, 8), num_users=MT_USERS,
                               num_items=MT_V), None),
    "MIND": ("matching", dict(interest_num=2, routing_rounds=2), None),
}


# port-only cases, each against the port's unsharded run at (2, 2):
# TransRec's replicated bias beside its sharded table (`shard_slice`),
# BERT4Rec's [MASK] row past the scored columns, FDSA's feature table,
# NeuMF trained through `full_scores` (its tables gathered whole), Item2Vec
MT_PORT = {
    "TransRec": ("sequential", dict(num_users=MT_USERS), "full_scores"),
    "BERT4Rec": ("sequential", dict(n_layers=1, n_heads=2), "full_scores"),
    "FDSA": ("sequential", dict(n_layers=1, n_heads=2, feature_vocab=7),
             "full_scores"),
    "NeuMF-full": ("matching", dict(mlp_hidden_units=(16, 8),
                                    num_users=MT_USERS, num_items=MT_V),
                   "full_scores"),
    "Item2Vec": ("matching", {}, None),
}


def mt_feature_map(FM, FS, v=MT_V):
    """Users and items (either package's FeatureSpec / FeatureMap)."""
    return FM("mt", (FS("user_id", "categorical", source="user",
                        vocab_size=MT_USERS, embedding_dim=MT_D),
                     FS("item_id", "categorical", source="item",
                        vocab_size=v, embedding_dim=MT_D)),
              query_index="user_id", corpus_index="item_id", num_items=v)


def _mt_case(name):
    return MT_CASES[name] if name in MT_CASES else MT_PORT[name]


def mt_kwargs(name, v=MT_V):
    kw = dict(_mt_case(name)[1], embedding_dim=MT_D)
    if _mt_case(name)[0] == "sequential":
        kw.update(max_seq_len=MT_L, dropout=0.0)
    if name == "NeuMF":
        kw.update(num_items=v)
    if name == "MIND":
        kw.update(max_seq_len=MT_L)
    return kw


def mt_batch(seed=1, v=MT_V, b=MT_B):
    """One global batch every case reads: left-padded histories, their
    lengths, users, next-item targets and (B, 1 + negs) candidates, the
    target first."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, MT_L + 1, b).astype(np.int32)
    seq = rng.integers(1, v, (b, MT_L)).astype(np.int32)
    seq[np.arange(MT_L)[None, :] < (MT_L - lens)[:, None]] = 0
    target = rng.integers(1, v, b).astype(np.int32)
    cand = np.concatenate([target[:, None], rng.integers(
        1, v, (b, MT_NEGS))], axis=1).astype(np.int32)
    return {"item_seq": seq, "seq_len": lens, "item_id": target,
            "user_id": rng.integers(0, MT_USERS, b).astype(np.int32),
            "__item_ids__": cand, "item::item_id": cand,
            "feat_seq": np.where(seq > 0, seq % 6 + 1, 0).astype(np.int32),
            "center": seq[:, -1], "context": target,
            "neg": cand[:, 1:]}


def mt_model(name, state_path=None, v=MT_V):
    from recbox_tpu_torch import models
    mod = getattr(models, _mt_case(name)[0])
    cls = name.split("-")[0]
    if cls == "Item2Vec":
        model = mod.Item2Vec(v, MT_D, device="cpu")
    else:
        model = getattr(mod, cls)(mt_feature_map(FeatureMap, FeatureSpec,
                                                 v),
                                  device="cpu", **mt_kwargs(name, v))
    if state_path is not None:
        model.load_state_dict(torch.load(state_path, weights_only=True))
    return model


def mt_loss(name):
    from recbox_tpu_torch.ops.losses import (
        full_softmax_loss, get_matching_loss,
    )
    if _mt_case(name)[2] == "full_scores":
        return lambda o, b: full_softmax_loss(o, b["item_id"])
    if name == "Item2Vec":
        from recbox_tpu_torch.models.matching import sgns_loss
        return lambda o, b: sgns_loss(o)
    match = get_matching_loss("SoftmaxCrossEntropyLoss")
    return lambda o, b: match(o)


def mt_trainer(name, model, mesh, lr=1e-2):
    return Trainer(model, mt_loss(name),
                   TrainerConfig(learning_rate=lr, epochs=1, monitor="AUC",
                                 seed=5),
                   mesh=mesh, device="cpu", train_method=_mt_case(name)[2])


def mt_steps(name, state_path, batch, mesh, steps=3, v=MT_V):
    """``steps`` steps of one global batch; (trainer, losses)."""
    mine = local_rows(batch, mesh) if mesh is not None else batch
    t = mt_trainer(name, mt_model(name, state_path, v), mesh)
    t.init(mine)
    return t, [float(t.train_step(dict(mine))) for _ in range(steps)]


def mesh_tables(rank, world, states, batch_path, meshes, ragged_state,
                ckpt_dir):
    """Every case at every mesh shape (n_model): 3 steps from the saved
    state, the losses, the whole parameters (gathered) and each sharded
    table's local shape; SASRec's collective bytes a step at V and 2V; a
    save / load round trip of a sharded SASRec read back by `predict`;
    SASRec over a ragged vocabulary (V = 50: the last shard padded)."""
    from recbox_tpu_torch.data.loader import ArrayLoader
    from recbox_tpu_torch.parallel.mesh import barrier
    with np.load(batch_path) as z:
        batch = {k: z[k] for k in z.files}
    out = {}
    built = {m: make_mesh(m, device="cpu") for m in meshes}
    for m in meshes:
        for name, path in sorted(states.items()):
            if name in MT_PORT and m != 2:
                continue
            t, losses = mt_steps(name, path, batch, built[m])
            out[f"{name}/m{m}/loss"] = np.asarray(losses)
            for k, v in t.state_dict()["params"].items():
                out[f"{name}/m{m}/{k}"] = v.detach().numpy().copy()
            for k in t._row_shards():
                out[f"{name}/m{m}/local/{k}"] = np.asarray(
                    t.params[k].shape)
    # the collective bytes of SASRec's second step at V and 2V
    mesh = built[2]
    for v in (MT_V, 2 * MT_V):
        b = mt_batch(seed=2, v=v)
        mine = local_rows(b, mesh)
        torch.manual_seed(3)
        t = mt_trainer("SASRec", mt_model("SASRec", v=v), mesh)
        t.init(mine)
        t.train_step(dict(mine))
        ops = collective_stats(t.train_step, dict(mine))
        out[f"bytes/v{v}"] = np.asarray(sum(op.bytes for op in ops))
        out[f"kinds/v{v}"] = np.asarray(sorted(op.line for op in ops))
    # save a sharded SASRec, load it into a fresh trainer, predict
    path = os.path.join(ckpt_dir, "sasrec.ckpt")
    t, _ = mt_steps("SASRec", states["SASRec"], batch, mesh)
    t.save(path)
    barrier()
    torch.manual_seed(4)
    fresh = mt_trainer("SASRec", mt_model("SASRec"), mesh)
    fresh.init(local_rows(batch, mesh))
    fresh.load(path)
    rows = {k: batch[k] for k in ("item_seq", "seq_len", "__item_ids__",
                                  "item::item_id")}
    for tag, tr in (("trained", t), ("loaded", fresh)):
        out[f"predict/{tag}"] = tr.predict(ArrayLoader(
            rows, batch_size=8, shuffle=False))
    # the same through `OrbaxCheckpointer` (each rank writes its rows)
    from recbox_tpu_torch.training.checkpoint import OrbaxCheckpointer
    ck = OrbaxCheckpointer()
    odir = os.path.join(ckpt_dir, "sasrec_orbax")
    ck.save(odir, t.state_dict(sharded=True))
    ck.wait()
    torch.manual_seed(5)
    again = mt_trainer("SASRec", mt_model("SASRec"), mesh)
    again.init(local_rows(batch, mesh))
    again.load_state_dict(ck.load(odir, again.state_dict(sharded=True)))
    out["predict/orbax"] = again.predict(ArrayLoader(
        rows, batch_size=8, shuffle=False))
    # a ragged vocabulary
    rb = mt_batch(seed=5, v=50)
    _, losses = mt_steps("SASRec", ragged_state, rb, built[4], v=50)
    out["ragged/loss"] = np.asarray(losses)
    # the pipelines end to end on a (2, 2) mesh
    for name, run in mt_pipelines(mesh).items():
        for k, v in run.items():
            out[f"pipeline/{name}/{k}"] = np.asarray(v)
    return out


MT_PIPE = {"model": "SASRec", "embedding_dim": MT_D, "max_seq_len": MT_L,
           "n_layers": 1, "n_heads": 2, "dropout": 0.0, "epochs": 2,
           "batch_size": 32, "learning_rate": 1e-2, "eval_batch_size": 64,
           "seed": 3, "monitor": "NDCG(k=10)"}


def mt_pipelines(mesh=None):
    """`run_sequential_experiment` and `run_matching_experiment` (SASRec
    on the full softmax) over 256 training rows and 96 held-out users,
    with or without a mesh; their metrics."""
    from recbox_tpu_torch import quick_start as qs
    fm = mt_feature_map(FeatureMap, FeatureSpec)
    train, valid, test = (mt_batch(seed=s, b=n) for s, n in
                          ((11, 256), (12, 96), (13, 96)))
    keep = ("item_seq", "seq_len", "item_id", "user_id")
    train, valid, test = ({k: d[k] for k in keep}
                          for d in (train, valid, test))
    seq = qs.run_sequential_experiment(dict(MT_PIPE), fm, train, valid,
                                       test, mesh=mesh, device="cpu")
    users = {k: valid[k] for k in ("item_seq", "seq_len")}
    match = qs.run_matching_experiment(
        dict(MT_PIPE, loss="FullSoftmaxCE", monitor="Recall(k=20)"), fm,
        train, {"item_id": np.arange(MT_V, dtype=np.int32)}, users,
        np.arange(96), {}, {q: [int(t)] for q, t in enumerate(
            valid["item_id"])}, mesh=mesh, device="cpu")
    return {"sequential": seq, "matching": match}


# -- the graph and knowledge models' own tables (`test_torch_mesh_graph`) ------

MG_CATS, MG_REL, MG_D, MG_B, MG_NEGS, MG_L = 5, 3, 8, 16, 3, 5
MG_INTER, MG_LR = 200, 1e-2
# the cases held to JAX's sharded trainer: every sharded table divides
# over four devices (JAX's device_put requires it; KGAT's nodes are 44 +
# 24 = 68); the port-only cases and the pipelines leave the last shard
# padded (30 items, 41 entities, KGAT's 65 nodes)
MG_EVEN = dict(users=24, items=32, ents=44)
MG_RAGGED = dict(users=24, items=30, ents=41)
MG_GRAPH = ("LightGCN", "NGCF", "SGL", "NCL", "DGCF", "SpectralCF", "GCMC",
            "LINE")
# constructor keywords beyond the sizes and graph arrays
MG_KW = {
    "LightGCN": {}, "NGCF": {}, "SGL": dict(ssl_tau=0.3, drop_ratio=0.2),
    "NCL": dict(ssl_tau=0.2, hyper_layers=1),
    "DGCF": dict(n_intents=2, n_routing=2), "SpectralCF": {},
    "GCMC": dict(hidden_dim=6), "LINE": dict(order=2), "CKE": dict(kg_dim=4),
    "CFKG": {}, "KTUP": dict(n_preferences=3),
    "MKR": dict(n_layers_cc=2, user_hidden=(6,)), "KGCN": {},
    "KGNNLS": dict(aggregator="concat"), "KGAT": dict(n_layers=2, kg_dim=4),
    "RippleNet": dict(n_hops=2), "KGIN": dict(n_intents=3),
    "MCCLK": dict(ssl_tau=0.3), "KSR": dict(hidden_size=6, dropout=0.0),
}
# against JAX's sharded trainer at every mesh shape; the rest against the
# port's unsharded run at (2, 2), KGAT again over a node table the world
# does not divide
MG_JAX = ("LightGCN", "NGCF", "GCMC", "LINE", "KGAT", "KGIN", "CKE",
          "RippleNet", "KSR")
MG_PORT = ("SGL", "NCL", "DGCF", "SpectralCF", "KGCN", "KGNNLS", "CFKG",
           "KTUP", "MKR", "MCCLK", "KGAT-ragged")


def mg_size(case):
    # a case named '<model>-even' (`MC_CASES`) is held to JAX's sharded
    # trainer too
    return MG_EVEN if case in MG_JAX or case.endswith("-even") \
        else MG_RAGGED


def mg_world(users, items, ents, seed=0):
    """(interaction users, items, the KG): each item → its category
    (relation 1), 12 items → a plain entity (relation 2)."""
    from recbox_tpu_torch.data.knowledge import KnowledgeGraph
    rng = np.random.default_rng(seed)
    extra = rng.choice(items, 12, replace=False)
    heads = np.concatenate([np.arange(items), extra]).astype(np.int64)
    rels = np.concatenate([np.full(items, 1), np.full(12, 2)])
    tails = np.concatenate([items + np.arange(items) % MG_CATS,
                            items + MG_CATS + rng.integers(
                                0, ents - items - MG_CATS, 12)])
    kg = KnowledgeGraph(heads, rels.astype(np.int64), tails.astype(np.int64),
                        ents, MG_REL, items)
    return (rng.integers(0, users, MG_INTER).astype(np.int32),
            rng.integers(0, items, MG_INTER).astype(np.int32), kg)


def mg_u2i(users, items):
    out = {}
    for u, i in zip(users.tolist(), items.tolist()):
        out.setdefault(u, []).append(i)
    return out


def mg_graph(cls, users, items, ents, iu, ii, kg):
    """``cls``'s sizes and graph arrays (numpy) over the interactions
    ``iu`` / ``ii`` and the KG."""
    from recbox_tpu_torch.data.knowledge import (
        build_neighbor_table, collaborative_kg_edges,
    )
    from recbox_tpu_torch.models.matching import build_norm_edges
    if cls in MG_GRAPH:
        eu, ei, c = build_norm_edges(iu, ii, users, items)
        return dict(num_users=users, num_items=items, n_layers=2,
                    edge_users=eu, edge_items=ei, edge_coefs=c)
    if cls == "KSR":
        ents_k, _ = build_neighbor_table(kg, 2, 1)
        return dict(num_users=users, n_entities=ents, kg_neighbors=ents_k)
    sizes = dict(num_users=users, n_entities=ents, n_relations=MG_REL)
    if cls in ("CKE", "KTUP", "MKR", "KGCN", "KGNNLS", "RippleNet"):
        sizes["num_items"] = items
    if cls in ("KGCN", "KGNNLS"):
        ents_k, rels = build_neighbor_table(kg, 3, 0)
        return dict(sizes, neighbor_entities=ents_k, neighbor_relations=rels,
                    n_hops=2)
    if cls == "KGAT":
        h, r, t = collaborative_kg_edges(kg, iu, ii, users)
        return dict(sizes, ckg_heads=h, ckg_relations=r, ckg_tails=t)
    if cls in ("KGIN", "MCCLK"):
        return dict(sizes, inter_users=iu, inter_items=ii,
                    kg_heads=kg.heads.astype(np.int32),
                    kg_relations=kg.relations.astype(np.int32),
                    kg_tails=kg.tails.astype(np.int32))
    return sizes


def mg_case_graph(case, double=False):
    """A case's sizes and graph arrays over its world; ``double`` repeats
    the edge list (the bytes case)."""
    size = mg_size(case)
    iu, ii, kg = mg_world(**size)
    out = mg_graph(case.split("-")[0], **size, iu=iu, ii=ii, kg=kg)
    if double:
        for k in ("edge_users", "edge_items", "edge_coefs"):
            out[k] = np.concatenate([out[k], out[k]])
    return out


def mg_feature_map(FM, FS, users, items):
    """Users and items (either package's FeatureMap / FeatureSpec)."""
    return FM("mg", (FS("user_id", "categorical", source="user",
                        vocab_size=users, embedding_dim=MG_D),
                     FS("item_id", "categorical", source="item",
                        vocab_size=items, embedding_dim=MG_D)),
              query_index="user_id", corpus_index="item_id", num_items=items)


def mg_model(case, state_path=None, double=False):
    from recbox_tpu_torch.models import knowledge, matching
    cls = case.split("-")[0]
    size = mg_size(case)
    model = getattr(matching if cls in MG_GRAPH else knowledge, cls)(
        mg_feature_map(FeatureMap, FeatureSpec, size["users"],
                       size["items"]),
        embedding_dim=MG_D, device="cpu", **MG_KW[cls],
        **mg_case_graph(case, double))
    if state_path is not None:
        model.load_state_dict(torch.load(state_path, weights_only=True))
    return model


def mg_batch(case, seed=1, b=MG_B):
    """One global batch of ``case``'s columns: users and (B, 1 + negs)
    candidates, the positive first; RippleNet's users' ripple memories;
    KSR's left-padded histories, each with an id past the middle of the
    vocabulary, and their next items."""
    from recbox_tpu_torch.data.knowledge import build_ripple_sets
    size = mg_size(case)
    users, items = size["users"], size["items"]
    rng = np.random.default_rng(seed)
    if case == "KSR":
        lens = rng.integers(1, MG_L + 1, b).astype(np.int32)
        seq = rng.integers(1, items, (b, MG_L)).astype(np.int32)
        seq[:, -1] = rng.integers(items // 2 + 1, items, b)
        seq[np.arange(MG_L)[None, :] < (MG_L - lens)[:, None]] = 0
        return {"item_seq": seq, "seq_len": lens,
                "item_id": rng.integers(1, items, b).astype(np.int32)}
    cand = rng.integers(0, items, (b, 1 + MG_NEGS)).astype(np.int32)
    out = {"user_id": rng.integers(0, users, b).astype(np.int32),
           "__item_ids__": cand, "item::item_id": cand}
    if case == "RippleNet":
        iu, ii, kg = mg_world(**size)
        rs = build_ripple_sets(kg, mg_u2i(iu, ii), 2, 4, 0)
        row = {int(u): k for k, u in enumerate(rs["users"])}
        sel = np.array([row.get(int(u), 0) for u in out["user_id"]])
        for k in ("heads", "relations", "tails"):
            out[f"ripple_{k}"] = rs[k][sel]
    return out


def mg_loss(case, model):
    """``case``'s training loss as JAX writes it: BPR, KSR's full-softmax
    CE; SGL's and NCL's InfoNCE sums over the batch (SGL's on two fixed
    edge keep-masks: the trainer's draws are each rank's own; under a mesh
    the models weigh the sums by n_data, so the trainer's mean over 'data'
    leaves the global batch's sum), NCL's prototype term on the prototypes
    `mg_steps` takes before the steps (every rank calls `NCL.prototypes`),
    KGNNLS's label smoothness."""
    from recbox_tpu_torch.ops.losses import (
        full_softmax_loss, get_matching_loss,
    )
    bpr = get_matching_loss("PairwiseLogisticLoss")
    if case == "KSR":
        return lambda o, b: full_softmax_loss(o, b["item_id"])
    if case == "SGL":
        masks = [torch.from_numpy(m)
                 for m in sgl_masks(model.edge_users.shape[0])]
        return lambda o, b: bpr(o) + model.ssl_loss(b, masks)
    if case == "NCL":
        return lambda o, b: bpr(o) + model.structural_loss(b) \
            + model.prototype_loss(b, *model.mg_protos)
    if case == "KGNNLS":
        iu, ii, _ = mg_world(**mg_size(case))
        labels = torch.zeros(model.num_users, model.n_entities)
        labels[torch.from_numpy(iu).long(), torch.from_numpy(ii).long()] = 1

        def ls(o, b):
            ids = b["__item_ids__"]
            target = torch.zeros(ids.shape)
            target[:, 0] = 1.0
            return bpr(o) + model.ls_loss(
                b, ids, labels[b["user_id"].long()], target)
        return ls
    return lambda o, b: bpr(o)


def sgl_masks(n):
    """SGL's two fixed (n,) edge keep-masks (f32 0 / 1)."""
    rng = np.random.default_rng(3)
    return [(rng.random(n) > 0.2).astype(np.float32) for _ in range(2)]


def mg_trainer(case, model, mesh):
    return Trainer(model, mg_loss(case, model),
                   TrainerConfig(learning_rate=MG_LR, epochs=1,
                                 monitor="AUC", seed=5),
                   mesh=mesh, device="cpu",
                   train_method="full_scores" if case == "KSR" else None)


def mg_steps(case, state_path, batch, mesh, steps=3):
    """``steps`` steps of one global batch from the saved state; (trainer,
    losses)."""
    mine = local_rows(batch, mesh) if mesh is not None else batch
    model = mg_model(case, state_path)
    t = mg_trainer(case, model, mesh)
    t.init(mine)
    if case == "NCL":       # on the gathered tables, after the sharding
        model.mg_protos = model.prototypes(3, n_iters=5)
    return t, [float(t.train_step(dict(mine))) for _ in range(steps)]


def mesh_graph(rank, world, states, batch_dir, meshes, pipelines=()):
    """Every case at its mesh shapes (n_model; the port-only cases at 2):
    3 steps from the saved state, the losses, the whole parameters, each
    sharded table's local shape and real rows, NCL's prototypes; with
    LightGCN among the cases, its collective bytes a step at E and 2E
    edges and the trained model served on a ('model') mesh against an
    unsharded service of its gathered weights; ``pipelines``
    (`mg_pipelines`) on a (2, 2) mesh."""
    built = {m: make_mesh(m, device="cpu") for m in meshes}
    out = {}
    for m in meshes:
        for case in sorted(states):
            if case not in MG_JAX and m != 2:
                continue
            with np.load(os.path.join(batch_dir, f"{case}.npz")) as z:
                batch = {k: z[k] for k in z.files}
            t, losses = mg_steps(case, states[case], batch, built[m])
            out[f"{case}/m{m}/loss"] = np.asarray(losses)
            for k, v in t.state_dict()["params"].items():
                out[f"{case}/m{m}/{k}"] = v.detach().numpy().copy()
            for k, shard in t._row_shards().items():
                out[f"{case}/m{m}/local/{k}"] = np.asarray(
                    tuple(t.params[k].shape) + (shard.valid,))
                out[f"{case}/m{m}/padding/{k}"] = np.asarray(
                    float(t.params[k][shard.valid:].abs().sum()))
            if case == "NCL":
                for i, p in enumerate(t.model.mg_protos):
                    out[f"NCL/m{m}/protos{i}"] = np.asarray(p)
            if case == "LightGCN" and m == 2:
                out.update(_mg_service(t, built[4]))
            if case in MG_FULL_SCORES and m == 2:
                out[f"{case}/full_scores"] = _mg_full_scores(
                    case, states[case], batch, built[m])
    # the collective bytes of LightGCN's second step at E and 2E
    mesh = built[2]
    b = mg_batch("LightGCN", seed=2)
    mine = local_rows(b, mesh)
    for tag, double in (("E", False), ("2E", True)) if "LightGCN" in states \
            else ():
        torch.manual_seed(3)
        model = mg_model("LightGCN", double=double)
        t = mg_trainer("LightGCN", model, mesh)
        t.init(mine)
        t.train_step(dict(mine))
        ops = collective_stats(t.train_step, dict(mine))
        out[f"bytes/{tag}"] = np.asarray(sum(op.bytes for op in ops))
        out[f"kinds/{tag}"] = np.asarray(sorted(op.line for op in ops))
        out[f"edges/{tag}"] = np.asarray(len(model.edge_users))
    for name, run in mg_pipelines(pipelines, mesh).items():
        for k, v in run.items():
            out[f"pipeline/{name}/{k}"] = np.asarray(v)
    return out


# the pair-scoring models, whose ``full_scores`` read their sharded tables
# whole inside `parallel.mesh.whole_tables`
MG_FULL_SCORES = ("KGCN", "KTUP", "RippleNet")


def _mg_full_scores(case, state_path, batch, mesh):
    """``full_scores`` of this rank's rows of ``batch`` from the saved
    state, the model's tables sharded over ``mesh``."""
    from recbox_tpu_torch.parallel.mesh import shard_params
    model = mg_model(case, state_path)
    shard_params(model, mesh)
    mine = {k: torch.from_numpy(v) for k, v in
            local_rows(batch, mesh).items()}
    with torch.no_grad():
        return model.eval().full_scores(mine)


def _mg_service(trainer, mesh):
    """The trained LightGCN served through `RetrievalService.from_trainer`
    on ``mesh`` (the index over 'model', every rank encoding the corpus),
    and an unsharded service over its gathered weights in this process."""
    from recbox_tpu_torch.parallel.mesh import full_state_dict
    from recbox_tpu_torch.retrieval import RetrievalService
    size = mg_size("LightGCN")
    corpus = {"item_id": np.arange(size["items"], dtype=np.int32)}
    users = {"user_id": np.arange(size["users"], dtype=np.int32)}
    svc = RetrievalService.from_trainer(trainer, corpus, mesh=mesh,
                                        method="exact", batch_size=16)
    s, i = svc.query(users, k=5)
    plain = mg_model("LightGCN")
    plain.load_state_dict(full_state_dict(trainer.model))
    ps, pi = RetrievalService(plain, corpus, method="exact",
                              batch_size=16, device="cpu").query(users, k=5)
    return {"svc/scores": s, "svc/ids": i, "svc/plain_scores": ps,
            "svc/plain_ids": pi}


MG_PIPE = dict(embedding_dim=MG_D, epochs=2, batch_size=16, num_negs=2,
               eval_batch_size=16, learning_rate=1e-2, seed=3,
               monitor="Recall(k=20)", kg_batch_size=16,
               kg_steps_per_epoch=3)


def mg_pipelines(names, mesh=None):
    """Of ``names``: `run_matching_experiment` (LightGCN) and
    `run_kg_experiment` (KGAT, CKE: their CF and KG phases) over the ragged
    world's first 160 interactions, the rest held out, with or without a
    mesh; their metrics. The evaluators encode in batches of 16 (two user
    and two corpus batches, each propagating)."""
    from recbox_tpu_torch import quick_start as qs
    size = MG_RAGGED
    iu, ii, kg = mg_world(**size)
    fm = mg_feature_map(FeatureMap, FeatureSpec, size["users"],
                        size["items"])
    train = {"user_id": iu[:160], "item_id": ii[:160]}
    held = mg_u2i(iu[160:], ii[160:])
    queries = np.asarray(sorted(held), np.int64)
    users = {"user_id": queries.astype(np.int32)}
    corpus = {"item_id": np.arange(size["items"], dtype=np.int32)}
    t2i = mg_u2i(train["user_id"], train["item_id"])
    out = {}
    for name in names:
        cfg = dict(MG_PIPE, model=name, **MG_KW[name], **mg_graph(
            name, **size, iu=train["user_id"], ii=train["item_id"], kg=kg))
        if name == "LightGCN":
            out[name] = qs.run_matching_experiment(
                cfg, fm, train, corpus, users, queries, t2i, held,
                mesh=mesh, device="cpu")
        else:
            out[name] = qs.run_kg_experiment(
                cfg, fm, train, corpus, kg, users, queries, t2i, held,
                mesh=mesh, device="cpu")
    return out


def ksr_history(rank, world, state_path, batch_path):
    """KSR on a ('data') mesh of the world from the saved state, its item
    and entity tables row-sharded: this rank's user tower, training scores
    and full-softmax CE over the sharded logits, each rank on its rows of
    one global batch."""
    from recbox_tpu_torch.ops.losses import full_softmax_loss
    from recbox_tpu_torch.parallel.mesh import shard_params
    with np.load(batch_path) as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    mesh = make_mesh(1, device="cpu")
    mine = local_rows(batch, mesh)
    model = mg_model("KSR", state_path)
    shard_params(model, mesh)
    model.eval()
    with torch.no_grad():
        return {"user": model.user_tower(mine),
                "scores": model(dict(mine, **{
                    "__item_ids__": mine["cand"],
                    "item::item_id": mine["cand"]})),
                "ce": full_softmax_loss(model.full_scores(mine),
                                        mine["item_id"]),
                "rows": np.asarray(model.emb_item.shape[0])}


# -- the contrastive terms over the global batch --------------------------------

# YoutubeSBC's in-batch negatives, SGL's and NCL's contrastive sums and
# MCCLK's in-batch InfoNCE under JAX's loss functions; the graph cases over
# `MG_EVEN`'s world (every sharded table divides over four ranks)
MC_CASES = ("YoutubeSBC", "SGL-even", "NCL-even", "MCCLK-even")
MC_USERS, MC_ITEMS, MC_HIDDEN = 24, 32, (16, MG_D)
# (optimizer, lr) a case: YoutubeSBC's item-side output bias shifts each
# row's scores alike, so its gradient is rounding noise, which Adam's
# division by its root mean square turns into moves of ~lr in either
# package (its unsharded runs part by 3e-4 at the fourth step); plain SGD
# moves it by lr times the noise
MC_OPT = {"YoutubeSBC": ("sgd", 0.5)}


def mc_config(case):
    opt, lr = MC_OPT.get(case, ("adam", MG_LR))
    return dict(optimizer=opt, learning_rate=lr, epochs=1, monitor="AUC",
                seed=5)


def mc_feature_map(FM, FS):
    """YoutubeSBC's users and items (either package's FeatureMap)."""
    return mg_feature_map(FM, FS, MC_USERS, MC_ITEMS)


def mc_log_q():
    """Each item's log sampling probability (a popularity)."""
    p = np.random.default_rng(11).uniform(1.0, 20.0, MC_ITEMS)
    return np.log(p / p.sum()).astype(np.float32)


def mc_batch(case, seed=1, b=MG_B):
    """One global batch: YoutubeSBC's users and positive items (distinct
    items: an in-batch negative equal to the positive would be a positive
    too); a graph case's `mg_batch`."""
    if case != "YoutubeSBC":
        return mg_batch(case, seed, b)
    rng = np.random.default_rng(seed)
    return {"user_id": rng.integers(0, MC_USERS, b).astype(np.int32),
            "item_id": rng.choice(MC_ITEMS, b, replace=False).astype(
                np.int32)}


def mc_model(case, state_path=None):
    if case != "YoutubeSBC":
        return mg_model(case, state_path)
    from recbox_tpu_torch.models.matching import YoutubeSBC
    model = YoutubeSBC(mc_feature_map(FeatureMap, FeatureSpec),
                       embedding_dim=MG_D, user_hidden_units=MC_HIDDEN,
                       item_hidden_units=MC_HIDDEN, device="cpu")
    if state_path is not None:
        model.load_state_dict(torch.load(state_path, weights_only=True))
    return model


def mc_loss(case, model, protos=None):
    """``case``'s loss as JAX writes it: YoutubeSBC's in-batch sampled
    softmax with the rank's rows' log q; BPR plus SGL's InfoNCE sum (on
    `sgl_masks`), NCL's structural sum and prototype mean (on
    ``protos``), MCCLK's in-batch InfoNCE."""
    from recbox_tpu_torch.models.matching import sampled_softmax_inbatch_loss
    from recbox_tpu_torch.ops.losses import get_matching_loss
    if case == "YoutubeSBC":
        log_q = torch.from_numpy(mc_log_q())
        return lambda o, b: sampled_softmax_inbatch_loss(
            o, log_q[b["item_id"].long()])
    bpr = get_matching_loss("PairwiseLogisticLoss")
    cls = case.split("-")[0]
    if cls == "SGL":
        masks = [torch.from_numpy(m)
                 for m in sgl_masks(model.edge_users.shape[0])]
        return lambda o, b: bpr(o) + model.ssl_loss(b, masks)
    if cls == "NCL":
        return lambda o, b: bpr(o) + model.structural_loss(b) \
            + model.prototype_loss(b, *protos)
    return lambda o, b: bpr(o) + model.contrastive_loss(b)


def mc_steps(case, state_path, batch, mesh, protos=None, steps=3):
    """``steps`` steps of one global batch from the saved state; (trainer,
    losses)."""
    mine = local_rows(batch, mesh) if mesh is not None else batch
    model = mc_model(case, state_path)
    t = Trainer(model, mc_loss(case, model, protos),
                TrainerConfig(**mc_config(case)),
                mesh=mesh, device="cpu",
                train_method="inbatch_scores" if case == "YoutubeSBC"
                else None)
    t.init(mine)
    return t, [float(t.train_step(dict(mine))) for _ in range(steps)]


def mesh_contrastive(rank, world, states, batch_dir, meshes, protos_path):
    """Every case at every mesh shape (n_model): 3 steps from the saved
    state, the losses and the whole parameters."""
    with np.load(protos_path) as z:
        protos = [z[f"p{i}"] for i in range(4)]
    out = {}
    for m in meshes:
        mesh = make_mesh(m, device="cpu")
        for case in MC_CASES:
            with np.load(os.path.join(batch_dir, f"{case}.npz")) as z:
                batch = {k: z[k] for k in z.files}
            t, losses = mc_steps(case, states[case], batch, mesh, protos)
            out[f"{case}/m{m}/loss"] = np.asarray(losses)
            for k, v in t.state_dict()["params"].items():
                out[f"{case}/m{m}/{k}"] = v.detach().numpy().copy()
    return out


# -- the cloze and MIP heads under a mesh ---------------------------------------

# the item vocabulary: with the [MASK] row the tables' 64 rows divide over
# four ranks; P masked positions a row
CZ_V, CZ_P, CZ_B = 63, 2, 8
CZ_CASES = ("BERT4Rec", "S3Rec")


def cz_feature_map(FM, FS):
    return mt_feature_map(FM, FS, CZ_V)


def cz_model(case, state_path=None):
    from recbox_tpu_torch.models import sequential
    kw = dict(embedding_dim=MT_D, max_seq_len=MT_L, n_layers=1, n_heads=2,
              dropout=0.0)
    model = getattr(sequential, case)(cz_feature_map(FeatureMap, FeatureSpec),
                                      device="cpu", **kw)
    if state_path is not None:
        model.load_state_dict(torch.load(state_path, weights_only=True))
    return model


def cz_batch(seed=2, b=CZ_B):
    """Left-padded histories with [MASK] (id V) at the last ``CZ_P``
    positions, their true items, and the positions' weights (a pad
    position, weight 0, in every third row)."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(1, CZ_V, (b, MT_L)).astype(np.int32)
    pos = np.tile(np.arange(MT_L - CZ_P, MT_L, dtype=np.int32), (b, 1))
    labels = np.take_along_axis(seq, pos, axis=1).astype(np.int32)
    seq[:, MT_L - CZ_P:] = CZ_V
    w = np.ones((b, CZ_P), np.float32)
    w[::3, 0] = 0.0
    return {"item_seq": seq, "seq_len": np.full(b, MT_L, np.int32),
            "positions": pos, "labels": labels, "weights": w}


def cz_heads(case, model, b):
    """``case``'s head on batch ``b``: BERT4Rec's `masked_item_scores`,
    S3Rec's `mip_logits`."""
    head = model.masked_item_scores if case == "BERT4Rec" \
        else model.mip_logits
    return head(b["item_seq"], b["seq_len"], b["positions"])


def mesh_cloze(rank, world, states, batch_path, meshes):
    """Each head at every mesh shape (n_model) on this rank's rows of one
    global batch, from the saved state: the weighted CE through
    `vocab_parallel_ce` (the world's mean of the ranks' values), the
    gradient of JAX's objective (this rank's value over n_data, the
    replicated parameters' gradients summed over 'data', the sharded
    table's gathered whole), and this rank's rows' hit positions
    (`sharded_hit_positions`)."""
    from recbox_tpu_torch.parallel.mesh import (
        all_reduce_, gather_rows, row_shard, shard_params,
        sharded_hit_positions, vocab_parallel_ce,
    )
    with np.load(batch_path) as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    out = {}
    for m in meshes:
        mesh = make_mesh(m, device="cpu")
        nd = mesh_shape(mesh)[DATA_AXIS]
        mine = local_rows(batch, mesh)
        for case in CZ_CASES:
            model = cz_model(case, states[case])
            shard_params(model, mesh)
            logits = cz_heads(case, model, mine)
            loss = vocab_parallel_ce(logits, mine["labels"],
                                     mine["weights"])
            names = [n for n, p in model.named_parameters()]
            params = [p for p in model.parameters()]
            grads = torch.autograd.grad(loss / nd, params, allow_unused=True)
            for n, p, g in zip(names, params, grads):
                g = torch.zeros_like(p) if g is None else g.contiguous()
                shard = row_shard(p)
                if shard is None:
                    all_reduce_(g, mesh, DATA_AXIS)
                else:
                    g = gather_rows(g, shard.rows, mesh)
                out[f"{case}/m{m}/grad/{n}"] = g.numpy()
            world_loss = all_reduce_(loss.detach().reshape(1).clone(), mesh)
            out[f"{case}/m{m}/loss"] = world_loss.numpy() / world
            out[f"{case}/m{m}/hits"] = sharded_hit_positions(
                logits, mine["labels"]).numpy()
            out[f"{case}/m{m}/rows"] = np.asarray(
                mesh_coords(mesh)[0] * mine["labels"].numel())
            out[f"{case}/m{m}/unweighted"] = all_reduce_(
                vocab_parallel_ce(logits, mine["labels"]).detach().reshape(
                    1).clone(), mesh).numpy() / world
    return out
