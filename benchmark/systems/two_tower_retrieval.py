"""Two-tower retrieval served by the port's `RetrievalService`: YoutubeDNN's
towers over a corpus encoded at set-up, a closed loop of ``query`` calls,
and the comparison of the served top-k with the plain reference.

The benchmark draws the weights and the queries from the seed and hands the
same to the port and to the reference. The index's lower-precision path
(``quantize='int8'``) is the control.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import traffic as gen_traffic
from benchmark.trace import Phases


def make_weights(gen: torch.Generator, cfg: dict, device
                 ) -> Dict[str, torch.Tensor]:
    """The model's weights by the port's parameter names: the tables
    N(0, table_std), the user MLP's kernels Xavier-normal, biases zero."""
    d, n, u = cfg["embedding_dim"], cfg["num_items"], cfg["num_users"]
    std = cfg["table_std"]
    w = {"user_embedding.tables.user_id":
         std * torch.randn((u, d), generator=gen, device=device),
         "user_embedding.tables.item_id":
         std * torch.randn((n + 1, d), generator=gen, device=device),
         "item_embedding.tables.item_id":
         std * torch.randn((n + 1, d), generator=gen, device=device)}
    fan_in = 2 * d
    for i, width in enumerate(cfg["hidden_units"]):
        scale = (2.0 / (fan_in + width)) ** 0.5
        w[f"user_mlp.dense.{i}.weight"] = scale * torch.randn(
            (width, fan_in), generator=gen, device=device)
        w[f"user_mlp.dense.{i}.bias"] = torch.zeros(width, device=device)
        fan_in = width
    return w


def build_service(cfg: dict, w: Dict[str, torch.Tensor], device,
                  control: bool):
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.matching import YoutubeDNN
    from recbox_tpu_torch.retrieval import RetrievalService
    d, n, u = cfg["embedding_dim"], cfg["num_items"], cfg["num_users"]
    fm = FeatureMap(cfg["name"], (
        FeatureSpec("user_id", "categorical", source="user", vocab_size=u,
                    embedding_dim=d),
        FeatureSpec("hist", "sequence", source="user", vocab_size=n + 1,
                    embedding_dim=d, max_len=cfg["max_history"],
                    share_embedding="item_id", padding_idx=n),
        FeatureSpec("item_id", "categorical", source="item", vocab_size=n,
                    embedding_dim=d)),
        query_index="user_id", corpus_index="item_id", num_items=n)
    model = YoutubeDNN(fm, embedding_dim=d, similarity=cfg["similarity"],
                       temperature=cfg["temperature"],
                       hidden_units=tuple(cfg["hidden_units"]),
                       activation=cfg["activation"], dropout=cfg["dropout"],
                       device=device)
    model.load_state_dict(w)
    index = dict(cfg["index"])
    if control:
        index["quantize"] = "int8"
    return RetrievalService(model, {"item_id": np.arange(n, dtype=np.int64)},
                            device=device, **index)


def setup(cfg: dict, traffic: dict, seed: int, device, ref,
          control: bool = False):
    """Weights and a pool of queries from the seed, the service over them
    (the corpus encoded), and every shape of the window warmed. With
    ``control`` the index is int8 (the port's lower-precision path)."""
    clock = Phases(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = make_weights(gen, cfg, device)
    clock.mark("weights")
    q = traffic["users_per_query"]
    pool = gen_traffic.histories(gen, traffic, cfg["num_users"],
                                 cfg["num_items"], cfg["max_history"],
                                 traffic["pool_queries"] * q, device)
    pool = {key: v.cpu().numpy().reshape(
        (traffic["pool_queries"], q) + tuple(v.shape[1:]))
        for key, v in pool.items()}
    clock.mark("queries")
    svc = build_service(cfg, w, device, control)
    clock.mark("service and corpus")
    for i in range(2):
        svc.query({key: v[i] for key, v in pool.items()}, k=traffic["k"])
        clock.mark(f"warm query {i + 1}")
    return SimpleNamespace(cfg=cfg, traffic=traffic, seed=seed, device=device,
                           w=w, pool=pool, svc=svc, phases=clock)


def window(st, seconds: float) -> dict:
    """The closed loop: one client sends the pool's queries in turn, each
    as soon as the last one's results are on the host, until ``seconds``
    have passed. Keeps ``check.rows`` served rows of each call of a
    reservoir of ``check.calls`` calls drawn from the seed."""
    t = st.traffic
    k, q, n_pool = t["k"], t["users_per_query"], t["pool_queries"]
    n_keep, n_rows = t["check"]["calls"], t["check"]["rows"]
    rng = np.random.default_rng([st.seed, 1])
    kept: List[tuple] = []
    lat: List[float] = []
    calls = 0
    t0 = time.perf_counter()
    while True:
        p = calls % n_pool
        a = time.perf_counter()
        with record_function("bench::query"):
            s, i = st.svc.query({key: v[p] for key, v in st.pool.items()},
                                k=k)
        b = time.perf_counter()
        lat.append(b - a)
        slot = calls if calls < n_keep else int(rng.integers(0, calls + 1))
        if slot < n_keep:
            rows = rng.choice(q, n_rows, replace=False)
            sample = (p, rows, s[rows], i[rows])
            if slot == len(kept):
                kept.append(sample)
            else:
                kept[slot] = sample
        calls += 1
        if b - t0 >= seconds:
            break
    return {"calls": calls, "users": calls * q, "window_s": b - t0,
            "latency_s": lat, "kept": kept}


def end_to_end(st, win: dict) -> Dict[str, float]:
    return {"serve_users_per_s": win["users"] / win["window_s"],
            "query_p95_ms": float(np.percentile(win["latency_s"], 95)) * 1e3}


def attempted_failed(st, win: dict, numbers: Dict[str, float]):
    return win["calls"], int(numbers["bad_rows"])


def layer_context(st, win: dict) -> dict:
    return {"calls": win["calls"], "users": win["users"],
            "users_per_call": st.traffic["users_per_query"],
            "k": st.traffic["k"], "config": st.cfg}


def free(st) -> None:
    """Drop the program's service and model before the reference runs."""
    st.svc = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(st, win: dict, ref) -> Dict[str, float]:
    """The kept rows against the reference's exact float32 top-k
    (`reference.youtubednn.compare`)."""
    dev, k = st.device, st.traffic["k"]
    cat = lambda xs, dt: torch.as_tensor(np.concatenate(xs), dtype=dt,
                                         device=dev)
    kept = win["kept"]
    users = cat([st.pool["user_id"][p][rows] for p, rows, _, _ in kept],
                torch.int64)
    hist = cat([st.pool["hist"][p][rows] for p, rows, _, _ in kept],
               torch.int64)
    served_s = cat([s for _, _, s, _ in kept], torch.float32)
    served_i = cat([i for _, _, _, i in kept], torch.int64)
    return ref.compare(st.w, st.cfg["num_items"], users, hist, served_s,
                       served_i, k)


def routes(diff: Dict[str, int], win: dict, expect: str) -> List[str]:
    """What the port's launch counters show of the window's route."""
    calls = win["calls"]
    b3 = diff.get("mips_fused_topk.launches.bf16", 0) \
        + diff.get("mips_fused_topk.launches.int8", 0)
    wgmma = diff.get("mips_topk.route_launches.wgmma", 0)
    b5 = diff.get("bitonic_topk.launches.bitonic_topk", 0)
    stream = diff.get("bitonic_topk.stream_launches.bitonic_topk", 0)
    taken = {"b3_wgmma": b3 == calls and wgmma == calls and b5 == 0,
             "b5_stream": b3 == 0 and stream >= calls}
    return [f"route: {calls} calls; B3 selection {b3}, stage (a) wgmma "
            f"{wgmma}; B5 {b5} (streaming {stream})",
            f"route {expect}: {'taken' if taken.get(expect) else 'NOT taken'}"]
