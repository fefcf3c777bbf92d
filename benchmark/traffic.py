"""The general traffic generators. A traffic mix is a JSON file of
parameters under ``traffic/``; these functions read it and draw the inputs
on the device from a `torch.Generator` seeded with the run's ``--seed``, so
the same seed gives the same inputs and every seed the same sizes.

Id distributions (``{"dist": ...}``):

- ``uniform``: every id of the vocabulary alike;
- ``zipf`` with exponent ``s``: rank r of the vocabulary drawn with
  probability ∝ r^-s, ranks mapped to ids by a permutation drawn from the
  seed (popularity is not ordered by id, as hashed buckets are not).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def ids(gen: torch.Generator, dist: dict, vocab: int, shape: Tuple[int, ...],
        device) -> torch.Tensor:
    """int64 ids in [0, vocab) of ``shape`` drawn by ``dist``."""
    if dist["dist"] == "uniform":
        return torch.randint(0, vocab, shape, generator=gen, device=device)
    if dist["dist"] == "zipf":
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64,
                             device=device)
        cdf = torch.cumsum(ranks ** -float(dist["s"]), 0)
        cdf /= cdf[-1].clone()
        perm = torch.randperm(vocab, generator=gen, device=device)
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float64)
        rank = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
        return perm[rank]
    raise ValueError(f"unknown id distribution {dist!r}")


def lengths(gen: torch.Generator, dist: dict, n: int, device
            ) -> torch.Tensor:
    """int64 lengths, uniform on [min, max]."""
    if dist["dist"] != "uniform":
        raise ValueError(f"unknown length distribution {dist!r}")
    return torch.randint(int(dist["min"]), int(dist["max"]) + 1, (n,),
                         generator=gen, device=device)


def histories(gen: torch.Generator, traffic: dict, n_users: int,
              n_items: int, max_len: int, n: int, device
              ) -> Dict[str, torch.Tensor]:
    """``n`` query rows: a user id and a history of item ids, padded with
    the pad id ``n_items`` past each row's length."""
    users = ids(gen, traffic["user_ids"], n_users, (n,), device)
    hist = ids(gen, traffic["history_ids"], n_items, (n, max_len), device)
    lens = lengths(gen, traffic["history_len"], n, device)
    pad = torch.arange(max_len, device=device)[None, :] >= lens[:, None]
    return {"user_id": users, "hist": hist.masked_fill(pad, n_items)}


def ctr_batches(gen: torch.Generator, traffic: dict, n_cat: int,
                n_num: int, vocab: int, batch: int, n: int, device
                ) -> Dict[str, torch.Tensor]:
    """``n`` training batches of ``batch`` rows stacked on a leading axis:
    categorical fields ``c<i>`` (int32 ids of ``traffic["ids"]``), numeric
    fields ``n<i>`` N(0, 1), and a click drawn from a fixed logistic model
    whose logit is the sum of per-id weights N(0, 1) of the first
    ``traffic["click_fields"]`` fields."""
    out = {f"c{i}": ids(gen, traffic["ids"], vocab, (n, batch), device)
           .to(torch.int32) for i in range(n_cat)}
    out.update({f"n{i}": torch.randn((n, batch), generator=gen,
                                     device=device) for i in range(n_num)})
    fields = int(traffic["click_fields"])
    weights = torch.randn((fields, vocab), generator=gen, device=device)
    logit = sum(weights[f][out[f"c{f}"].long()] for f in range(fields))
    out["click"] = (torch.rand((n, batch), generator=gen, device=device)
                    < torch.sigmoid(logit)).float()
    return out
