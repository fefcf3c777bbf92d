"""Cells cut to a size the CPU tests can hold: the configuration's widths
and the traffic's distributions kept, its counts of users, items, buckets,
rows and calls cut."""

from typing import Tuple


def small(spec, name: str) -> Tuple[dict, dict]:
    cell = spec.cell(name)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    if cfg["system"] == "two_tower_retrieval":
        cfg.update(num_users=1000, num_items=200_000, max_history=10)
        traffic.update(users_per_query=32, pool_queries=2,
                       k=min(traffic["k"], 50) if traffic["k"] < 1000
                       else 300,
                       check={"calls": 2, "rows": 8},
                       history_len={"dist": "uniform", "min": 1, "max": 10})
    else:
        cfg.update(num_categorical=4, num_numeric=3, buckets_per_field=1000,
                   batch_size=512)
        traffic.update(pool_batches=16)
    return cfg, traffic
