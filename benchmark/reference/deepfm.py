"""DeepFM training in plain PyTorch, float32: the first-order term, the
factorization machine and the deep tower over the field embeddings
(categorical fields looked up, numeric fields scaling a learned vector),
the mean binary cross-entropy of the logit, Adam on the dense parameters
after a clip of their global norm (optax's ``clip_by_global_norm`` and
``adam``), and row-wise AdaGrad on the tables, one update per occurrence
of an id from the accumulator before the step.

Guo, Tang, Ye, Li, He, "DeepFM: A Factorization-Machine based Neural
Network for CTR Prediction", IJCAI 2017. The weights are the benchmark's
own, keyed by the port's parameter names; nothing of the port is imported.

``rnd`` rounds every operand of the dense layers' products, forward and
backward (`tf32` for the control at the next precision below float32).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero on the dropped bits), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.rnd
        return r(g) @ r(b).T, r(a).T @ r(g), None


def matmul(a: torch.Tensor, b: torch.Tensor, rnd: Round) -> torch.Tensor:
    return a @ b if rnd is None else _MatMul.apply(a, b, rnd)


class DeepFM:
    """A DeepFM and its optimizer state, stepped batch by batch.

    ``w``: the starting weights by the port's names (``embedding.tables.c<i>``
    (V, D), ``linear.tables.c<i>`` (V, 1), ``embedding.numeric.n<i>`` (1,
    D), ``linear.numeric.n<i>`` (1, 1), ``lr_bias``, ``dnn_w1`` (F, D, H),
    ``dnn_b1``, ``dnn_rest.dense.<j>.weight`` / ``.bias``), copied here.
    ``cfg``: the configuration (fields, optimizer)."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict,
                 rnd: Round = None):
        opt = cfg["optimizer"]
        self.lr, self.clip = opt["learning_rate"], opt["grad_clip_norm"]
        self.emb_lr, self.eps = opt["embedding_lr"], opt["adagrad_eps"]
        self.b1, self.b2, self.adam_eps = 0.9, 0.999, 1e-8
        self.cats = [f"c{i}" for i in range(cfg["num_categorical"])]
        self.nums = [f"n{i}" for i in range(cfg["num_numeric"])]
        self.rnd = rnd
        self.tables = {k: v.detach().clone() for k, v in w.items()
                       if ".tables." in k}
        self.acc = {k: torch.full((v.shape[0],), float(opt["adagrad_init"]),
                                  device=v.device)
                    for k, v in self.tables.items()}
        self.dense = {k: v.detach().clone() for k, v in w.items()
                      if ".tables." not in k}
        self.mu = {k: torch.zeros_like(v) for k, v in self.dense.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.dense.items()}
        self.count = 0
        self.n_rest = sum(1 for k in self.dense
                          if k.startswith("dnn_rest.dense.")
                          and k.endswith(".weight"))

    def logits(self, p: Dict[str, torch.Tensor],
               rows: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        emb, lin = [], []
        for c in self.cats:
            emb.append(rows[f"embedding.tables.{c}"])
            lin.append(rows[f"linear.tables.{c}"])
        for n in self.nums:
            x = batch[n].float()[:, None]
            emb.append(x * p[f"embedding.numeric.{n}"])
            lin.append(x * p[f"linear.numeric.{n}"])
        x = torch.stack(emb)                                    # (F, B, D)
        first = torch.stack(lin).sum(dim=(0, 2)) + p["lr_bias"]
        s = x.sum(0)
        fm = 0.5 * (s * s - (x * x).sum(0)).sum(-1)
        f_, b_, d_ = x.shape
        h = matmul(x.permute(1, 0, 2).reshape(b_, f_ * d_),
                   p["dnn_w1"].reshape(f_ * d_, -1), self.rnd) + p["dnn_b1"]
        h = torch.relu(h)
        for j in range(self.n_rest):
            h = matmul(h, p[f"dnn_rest.dense.{j}.weight"].T, self.rnd) \
                + p[f"dnn_rest.dense.{j}.bias"]
            if j < self.n_rest - 1:
                h = torch.relu(h)
        return first + fm + h.reshape(-1)

    def step(self, batch: Dict[str, torch.Tensor]) -> dict:
        """One training step on ``batch``; returns the loss, the dense
        gradients after the clip (as Adam takes them) and the per-table
        gradients' summed mean squares (what the accumulators gain)."""
        ids = {c: batch[c].long() for c in self.cats}
        rows = {k: self.tables[k][ids[k.rsplit(".", 1)[1]]]
                .requires_grad_(True) for k in self.tables}
        p = {k: v.requires_grad_(True) for k, v in self.dense.items()}
        z = self.logits(p, rows, batch)
        y = batch["click"].float()
        loss = torch.mean(F.softplus(z) - y * z)
        names = list(p) + list(rows)
        grads = torch.autograd.grad(loss, [p[k] for k in p]
                                    + [rows[k] for k in rows])
        g = dict(zip(names, grads))
        with torch.no_grad():
            for v in self.dense.values():
                v.requires_grad_(False)
            dense = {k: g[k] for k in self.dense}
            norm = torch.sqrt(sum(torch.sum(v * v) for v in dense.values()))
            if norm >= self.clip:
                dense = {k: v / norm * self.clip for k, v in dense.items()}
            self.count += 1
            bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
            for k, v in dense.items():
                self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * v
                self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * v * v
                upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                            + self.adam_eps)
                self.dense[k] = self.dense[k] - self.lr * upd
            g2sum = {}
            deltas: List = []
            for k in self.tables:
                gi = g[k].float()
                g2 = torch.mean(gi * gi, dim=-1)
                idx = ids[k.rsplit(".", 1)[1]]
                deltas.append((k, idx, -self.emb_lr * gi
                               / (torch.sqrt(self.acc[k][idx] + g2)
                                  + self.eps)[:, None], g2))
                g2sum[k] = float(g2.sum())
            for k, idx, delta, g2 in deltas:
                self.tables[k].index_add_(0, idx, delta)
                self.acc[k].index_add_(0, idx, g2)
        return {"loss": float(loss.detach()), "dense": dense, "g2sum": g2sum}

    def weights(self) -> Dict[str, torch.Tensor]:
        return {**self.dense, **self.tables}
