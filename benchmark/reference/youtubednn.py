"""YoutubeDNN retrieval in plain PyTorch, float32: the user tower over the
user-id embedding and the masked mean of the history's item embeddings,
an MLP with ReLU between its layers, and the exact top-k of the dot product
with every item's embedding (the item tower is the item-id embedding).

Covington, Adams, Sargin, "Deep Neural Networks for YouTube
Recommendations", RecSys 2016. The weights are the benchmark's own, keyed
by the port's parameter names; nothing of the port is imported.
"""

from __future__ import annotations

from typing import Dict, List

import torch

USER = "user_embedding.tables.user_id"
HIST = "user_embedding.tables.item_id"
ITEM = "item_embedding.tables.item_id"


def mlp_keys(w: Dict[str, torch.Tensor]) -> List[str]:
    n = sum(1 for key in w if key.startswith("user_mlp.dense.")
            and key.endswith(".weight"))
    return [f"user_mlp.dense.{i}" for i in range(n)]


def user_vectors(w: Dict[str, torch.Tensor], user_id: torch.Tensor,
                 hist: torch.Tensor, pad: int) -> torch.Tensor:
    """(R, D) user vectors of R query rows; ``pad`` marks empty history
    slots."""
    mask = (hist != pad).to(torch.float32)
    h = w[HIST][hist] * mask[..., None]
    pooled = h.sum(1) / mask.sum(1).clamp(min=1e-12)[:, None]
    x = torch.cat([w[USER][user_id], pooled], dim=1)
    keys = mlp_keys(w)
    for i, key in enumerate(keys):
        x = x @ w[key + ".weight"].T + w[key + ".bias"]
        if i < len(keys) - 1:
            x = torch.relu(x)
    return x


@torch.no_grad()
def compare(w: Dict[str, torch.Tensor], n_items: int,
            user_id: torch.Tensor, hist: torch.Tensor,
            served_s: torch.Tensor, served_i: torch.Tensor, k: int,
            block: int = 64) -> Dict[str, float]:
    """The served top-k of R rows against the exact float32 one, in blocks
    of ``block`` rows. Gaps are in units of the standard deviation of the
    row's scores over the corpus:

    - ``score_err``: the widest gap between a served score and the
      reference's score of the served item (``score_rms``: their root mean
      square);
    - ``rank_gap``: the widest gap by which a row's worst served item lies
      below the reference's (k + m)-th best score, where m of the
      reference's top k are not served: an index that drops m of the top k
      (the fused kernel keeps one item a segment) and serves the next best
      in their place reads 0 but for rounding;
      (``rank_rms``: the root mean square over every served item of its
      gap below that score, 0 for an item above it);
    - ``miss_share``: the mean share of the reference's top k not served,
      held against the configuration's recall target: the rank gaps read
      0 for an index that serves the next best in place of any m of the
      top k;
    - ``bad_rows``: rows with an id outside the corpus, an id twice, or a
      score that is not finite (left out of the rest).
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        items = w[ITEM][:n_items]
        err = gap = sq = gsq = miss = 0.0
        bad = rows = 0
        for r0 in range(0, user_id.shape[0], block):
            sl = slice(r0, r0 + block)
            u = user_vectors(w, user_id[sl], hist[sl], n_items)
            scores = u @ items.T
            sigma = scores.std(dim=1, keepdim=True)
            top = torch.topk(scores, min(2 * k, n_items), dim=1)
            ids = served_i[sl].long()
            s = served_s[sl].float()
            srt = torch.sort(ids, dim=1).values
            ok = ((ids >= 0) & (ids < n_items)).all(1) \
                & torch.isfinite(s).all(1) \
                & ~(srt[:, 1:] == srt[:, :-1]).any(1)
            bad += int((~ok).sum())
            if not bool(ok.any()):
                continue
            ids, s, srt, sigma = ids[ok], s[ok], srt[ok], sigma[ok]
            scores, vals, order = scores[ok], top.values[ok], top.indices[ok]
            ref = scores.gather(1, ids)
            e = (s - ref).abs() / sigma
            err = max(err, float(e.max()))
            sq += float((e * e).sum())
            want = order[:, :k].contiguous()
            pos = torch.searchsorted(srt, want).clamp(max=k - 1)
            m = k - (srt.gather(1, pos) == want).sum(1)
            at = (k + m - 1).clamp(max=vals.shape[1] - 1)
            below = (vals.gather(1, at[:, None]) - ref).clamp(min=0) / sigma
            gap = max(gap, float(below.max()))
            gsq += float((below * below).sum())
            miss += float(m.sum()) / k
            rows += int(ok.sum())
        n = max(rows, 1)
        return {"score_err": err, "score_rms": (sq / (n * k)) ** 0.5,
                "rank_gap": gap, "rank_rms": (gsq / (n * k)) ** 0.5,
                "miss_share": miss / n,
                "bad_rows": float(bad)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
