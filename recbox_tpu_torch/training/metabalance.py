"""MetaBalance: gradient-magnitude balancing for multi-task training.

Counterpart of `recbox_tpu/training/metabalance.py`, a functional API (no
trainer of either package calls it): for parameters shared by the tasks,
each auxiliary task's gradient is rescaled so that its moving-average norm
tracks the main task's (task 0), relaxed by ``relax_factor``, and the
tasks' gradients are summed. The caller computes the per-task gradients
(one ``torch.autograd.grad`` a loss) and hands the sum to any optimizer.
A task's gradients are a mapping of name → tensor (or a sequence of
tensors); the state holds each task's moving-average norm of each tensor,
in the same structure.
"""

from __future__ import annotations

from typing import List, Mapping, NamedTuple, Sequence, Tuple, Union

import torch

__all__ = ["MetaBalanceState", "metabalance_init", "metabalance_combine"]

Grads = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]


class MetaBalanceState(NamedTuple):
    # per task, per tensor: the moving-average gradient norms
    norms: Tuple


def _leaves(tree: Grads) -> Tuple[List, List[torch.Tensor]]:
    if isinstance(tree, Mapping):
        keys = list(tree)
        return keys, [tree[k] for k in keys]
    return list(range(len(tree))), list(tree)


def _rebuild(like: Grads, keys: List, values: List):
    if isinstance(like, Mapping):
        return dict(zip(keys, values))
    return list(values)


def metabalance_init(n_tasks: int, params: Grads) -> MetaBalanceState:
    keys, leaves = _leaves(params)
    return MetaBalanceState(norms=tuple(
        _rebuild(params, keys, [torch.zeros((), device=t.device)
                                for t in leaves])
        for _ in range(n_tasks)))


def metabalance_combine(task_grads: Sequence[Grads], state: MetaBalanceState,
                        relax_factor: float = 0.7, beta: float = 0.9):
    """Balance the per-task gradients of shared parameters and sum them.

    ``task_grads`` holds one gradient structure a task (task 0 the main
    one, whose magnitude anchors the rest); ``relax_factor`` 0 leaves the
    auxiliary gradients as they are, 1 matches their norms to the main
    task's; ``beta`` is the moving average's decay. Returns (combined
    gradients, new state)."""
    keys, _ = _leaves(task_grads[0])
    all_leaves = [_leaves(g)[1] for g in task_grads]
    norm_leaves = [_leaves(n)[1] for n in state.norms]
    new_norms: List[List[torch.Tensor]] = [[] for _ in task_grads]
    combined = []
    for li in range(len(keys)):
        avgs = []
        for t, leaves in enumerate(all_leaves):
            n_avg = beta * norm_leaves[t][li] \
                + (1.0 - beta) * torch.linalg.vector_norm(leaves[li])
            new_norms[t].append(n_avg)
            avgs.append(n_avg)
        total = all_leaves[0][li]
        for t in range(1, len(task_grads)):
            scale = avgs[0] / torch.clamp(avgs[t], min=1e-12)
            eff = relax_factor * scale + (1.0 - relax_factor)
            total = total + all_leaves[t][li] * eff
        combined.append(total)
    like = task_grads[0]
    return (_rebuild(like, keys, combined),
            MetaBalanceState(norms=tuple(_rebuild(like, keys, n)
                                         for n in new_norms)))
