"""CTR training through the port's `PackedEmbeddingTrainer`: DeepFM over a
schema of categorical and numeric fields, K steps a `train_steps_fused`
call (one CUDA graph of the step replayed over staged batches, `fit`'s
``fused_steps`` route), and the comparison of its first K + 1 steps with
the plain reference.

Set-up builds one trainer from weights the benchmark draws from the seed
and drives it through its first K + 1 steps on distinct batches of the
pool: a call of one step, which the trainer runs eagerly as the first of
its warm-up steps, then a K-step call, whose first step is the second
warm-up step and whose other K - 1 steps are replays of the CUDA graph it
captures. That graph is the one the window replays: set-up reads the
program's state after the first step and after the K + 1, and hands that
same trainer to the window.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import torch
from torch.profiler import record_function

from benchmark import traffic as gen_traffic
from benchmark.trace import Phases

ADAM_B1 = 0.9


def make_weights(gen: torch.Generator, cfg: dict, device
                 ) -> Dict[str, torch.Tensor]:
    """The model's weights by the port's parameter names: the tables and
    the numeric fields' vectors N(0, table_std), the dense kernels
    Xavier-normal (the first at its flat (F · D, H) fan-in), biases zero."""
    d, v = cfg["embedding_dim"], cfg["buckets_per_field"]
    std = cfg["table_std"]
    nc, n_num = cfg["num_categorical"], cfg["num_numeric"]
    w = {}
    emb = std * torch.randn((nc, v, d + 1), generator=gen, device=device)
    for i in range(nc):
        w[f"embedding.tables.c{i}"] = emb[i, :, :d].contiguous()
        w[f"linear.tables.c{i}"] = emb[i, :, d:].contiguous()
    num = std * torch.randn((n_num, d + 1), generator=gen, device=device)
    for i in range(n_num):
        w[f"embedding.numeric.n{i}"] = num[i:i + 1, :d].clone()
        w[f"linear.numeric.n{i}"] = num[i:i + 1, d:].clone()
    hidden = cfg["hidden_units"]
    f = nc + n_num
    w["lr_bias"] = torch.zeros(1, device=device)
    w["dnn_w1"] = (2.0 / (f * d + hidden[0])) ** 0.5 * torch.randn(
        (f, d, hidden[0]), generator=gen, device=device)
    w["dnn_b1"] = torch.zeros(hidden[0], device=device)
    widths = list(hidden[1:]) + [1]
    fan_in = hidden[0]
    for j, width in enumerate(widths):
        w[f"dnn_rest.dense.{j}.weight"] = (2.0 / (fan_in + width)) ** 0.5 \
            * torch.randn((width, fan_in), generator=gen, device=device)
        w[f"dnn_rest.dense.{j}.bias"] = torch.zeros(width, device=device)
        fan_in = width
    return w


def build_trainer(cfg: dict, w: Dict[str, torch.Tensor], seed: int, device):
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.ranking import DeepFM
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.training import (
        PackedEmbeddingTrainer, TrainerConfig,
    )
    d = cfg["embedding_dim"]
    feats = tuple(
        FeatureSpec(f"c{i}", "categorical",
                    vocab_size=cfg["buckets_per_field"], embedding_dim=d)
        for i in range(cfg["num_categorical"])) + tuple(
        FeatureSpec(f"n{i}", "numeric", embedding_dim=d)
        for i in range(cfg["num_numeric"]))
    fm = FeatureMap(cfg["name"], feats, labels=("click",))
    model = DeepFM(fm, embedding_dim=d, hidden_units=cfg["hidden_units"],
                   activation=cfg["activation"], dropout=cfg["dropout"],
                   batch_norm=cfg["batch_norm"],
                   compute_dtype=cfg["compute_dtype"],
                   feature_major_compute=cfg["feature_major_compute"],
                   device=device)
    model.load_state_dict(w)
    opt = cfg["optimizer"]
    tcfg = TrainerConfig(optimizer=opt["dense"],
                         learning_rate=opt["learning_rate"],
                         grad_clip_norm=opt["grad_clip_norm"],
                         seed=seed % 2 ** 62)
    return PackedEmbeddingTrainer(
        model, lambda out, b: binary_crossentropy(out, b["click"]), tcfg,
        device=device, embedding_lr=opt["embedding_lr"],
        adagrad_init=opt["adagrad_init"], adagrad_eps=opt["adagrad_eps"],
        embedding_optimizer=opt["embedding"])


def _param_name(table_key: str) -> str:
    """The model's parameter name of a packed trainer's table key
    (``embedding/emb_c0`` → ``embedding.tables.c0``)."""
    path, leaf = table_key.rsplit("/", 1)
    return f"{path.replace('/', '.')}.tables.{leaf[len('emb_'):]}"


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def first_gradients(trainer) -> Dict[str, float]:
    """The norm of each leaf's first gradient as the optimizer took it,
    read from its state after one step: Adam's first moment over (1 - b1)
    for a dense leaf; for a table, sqrt(width · Σ accumulator), the norm of
    the per-occurrence row gradients whose mean squares the row-wise
    AdaGrad accumulators gained."""
    mu = trainer.state_dict()["opt_state"]["mu"]
    out = {n: _norm(m) / (1 - ADAM_B1) for n, m in zip(trainer.params, mu)}
    tables = trainer.tables
    for key, acc in trainer.accumulators.items():
        width = tables[key].shape[1]
        out[_param_name(key)] = float(
            torch.sqrt(width * torch.sum(acc.double())))
    return out


def changes(trainer, w: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The norm of each leaf's change from the starting weights."""
    full = trainer.full_params()
    return {n: _norm(full[n].detach() - w[n]) for n in w}


def setup(cfg: dict, traffic: dict, seed: int, device, ref,
          control: bool = False):
    """Weights and a pool of batches from the seed, and the trainer through
    its first K + 1 steps, the last K of them the window's own K-step call.
    With ``control`` the readings of the first steps are the reference's at
    TF32 in place of the program's (the control of `check`)."""
    clock = Phases(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = make_weights(gen, cfg, device)
    clock.mark("weights")
    pool = gen_traffic.ctr_batches(
        gen, traffic, cfg["num_categorical"], cfg["num_numeric"],
        cfg["buckets_per_field"], cfg["batch_size"], traffic["pool_batches"],
        device)
    clock.mark("batches")
    trainer = build_trainer(cfg, w, seed, device)
    clock.mark("trainer")
    k = traffic["steps_per_call"]
    block = lambda a, b: {key: v[a:b] for key, v in pool.items()}
    losses = [float(x) for x in trainer.train_steps_fused(block(0, 1))]
    grads = first_gradients(trainer)
    clock.mark("step 1")
    losses += [float(x) for x in trainer.train_steps_fused(block(1, 1 + k))]
    program = {"losses": losses, "grad": grads, "change": changes(trainer, w)}
    clock.mark(f"steps 2-{k + 1}, the window's {k}-step call")
    if control:
        program = reference_readings(cfg, w, first_batches(pool, k + 1), ref,
                                     rnd=ref.tf32)
    return SimpleNamespace(cfg=cfg, traffic=traffic, seed=seed, device=device,
                           w=w, pool=pool, trainer=trainer, block=block,
                           graph=getattr(trainer, "_graph", None),
                           program=program, k=k, phases=clock)


def window(st, seconds: float) -> dict:
    """K-step calls over the pool's blocks of K batches in turn, at most
    two calls in flight, until ``seconds`` have passed; ended by a
    synchronize."""
    k, n_blocks = st.k, st.traffic["pool_batches"] // st.k
    cuda = torch.device(st.device).type == "cuda"
    done: List = []
    losses, order = [], []
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        j = calls % n_blocks
        with record_function("bench::train_call"):
            losses.append(st.trainer.train_steps_fused(
                st.block(j * k, (j + 1) * k)))
        order.append(j)
        calls += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            done.append(ev)
            if len(done) > 2:
                done.pop(0).synchronize()
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    return {"calls": calls, "steps": calls * k,
            "examples": calls * k * st.cfg["batch_size"],
            "window_s": t1 - t0, "order": order, "losses": losses,
            "checked_graph": st.trainer._graph is st.graph}


def end_to_end(st, win: dict) -> Dict[str, float]:
    return {"train_examples_per_s": win["examples"] / win["window_s"]}


def attempted_failed(st, win: dict, numbers: Dict[str, float]):
    """The window's steps, and those whose loss is not finite."""
    losses = torch.cat(win["losses"])
    return win["steps"], int((~torch.isfinite(losses)).sum())


def layer_context(st, win: dict) -> dict:
    k, nc = st.k, st.cfg["num_categorical"]
    cache: Dict[int, int] = {}

    def unique_rows(b: int) -> int:
        """Distinct pack rows of pool batch ``b``."""
        if b not in cache:
            cache[b] = sum(int(torch.unique(st.pool[f"c{i}"][b]).numel())
                           for i in range(nc))
        return cache[b]

    step_batches = [j * k + s for j in win["order"] for s in range(k)]
    return {"steps": win["steps"], "examples": win["examples"],
            "config": st.cfg, "step_batches": step_batches,
            "unique_rows": unique_rows,
            "ids_per_step": nc * st.cfg["batch_size"]}


def free(st) -> None:
    st.trainer = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def first_batches(pool: Dict[str, torch.Tensor], n: int) -> List[dict]:
    return [{key: v[i] for key, v in pool.items()} for i in range(n)]


def reference_readings(cfg: dict, w, batches: List[dict], ref, rnd=None
                       ) -> dict:
    """The reference's losses of a step a batch from ``w``, its first
    gradients' norms and its changes' norms after the last."""
    model = ref.DeepFM(w, cfg, rnd=rnd)
    losses, grads = [], {}
    for i, b in enumerate(batches):
        out = model.step(b)
        losses.append(out["loss"])
        if i == 0:
            grads = {n: _norm(g) for n, g in out["dense"].items()}
            grads.update({n: (w[n].shape[1] * g2) ** 0.5
                          for n, g2 in out["g2sum"].items()})
    after = model.weights()
    return {"losses": losses, "grad": grads,
            "change": {n: _norm(after[n] - w[n]) for n in w}}


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The readings of a run against the reference's. Each gap is taken by
    the worst leaf: the gap between the two norms of a leaf over the larger
    of the reference's norm of that leaf and of the median leaf. Leaves
    whose reference first gradient is under a thousandth of the median
    leaf's are left out of the change (Adam moves them by round-off)."""
    def worst(a: dict, b: dict, keys):
        med = float(torch.tensor([b[n] for n in keys]).median())
        return max((abs(a[n] - b[n]) / max(b[n], med, 1e-30), n)
                   for n in keys)

    g_med = float(torch.tensor(list(want["grad"].values())).median())
    moved = [n for n in want["change"] if want["grad"][n] >= 1e-3 * g_med]
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  want["losses"])]
    grad, grad_leaf = worst(got["grad"], want["grad"], list(want["grad"]))
    change, change_leaf = worst(got["change"], want["change"], moved)
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "replay_loss_gap": max(losses[2:], default=0.0),
            "loss_gaps": losses, "grad_gap": grad, "change_gap": change,
            "grad_worst_leaf": grad_leaf, "change_worst_leaf": change_leaf,
            "left_out": sorted(set(want["change"]) - set(moved))}


def check(st, win: dict, ref) -> Dict[str, float]:
    """The first K + 1 steps' readings against the reference's."""
    want = reference_readings(st.cfg, st.w, first_batches(st.pool, st.k + 1),
                              ref)
    return compare(st.program, want)


def routes(diff: Dict[str, int], win: dict, expect: str) -> List[str]:
    b1 = diff.get("packed_delta.launches.packed_adagrad_update", 0)
    return [f"route: {win['steps']} steps, B1 {b1}; the window replayed "
            f"the checked graph: {'yes' if win['checked_graph'] else 'no'}",
            f"route {expect}: "
            f"{'taken' if b1 == win['steps'] else 'NOT taken'}"]
