"""Determinism: seed everything (reference `recbox/utils/torch_utils.py:23-30`,
recbole `init_seed` `utils/utils.py:188-205`).

Own copy of `recbox_tpu/utils/seeding.py`'s `seed_everything`: Python's
`random`, numpy's global generator and ``PYTHONHASHSEED`` as JAX seeds
them, plus torch's default generators (CPU and every CUDA device). JAX's
`training_key` has no counterpart: the port's trainers own explicit Philox
generators seeded from ``TrainerConfig.seed`` (`ROADMAP.md` Queue C 6).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

__all__ = ["seed_everything"]


def seed_everything(seed: int = 2024) -> None:
    random.seed(seed)
    np.random.seed(seed)
    # NOTE: affects SUBPROCESSES only — hash randomization for this
    # process was fixed at interpreter startup (set it in the launcher for
    # in-process str-hash determinism)
    os.environ["PYTHONHASHSEED"] = str(seed)
    # seeds the CPU generator and, lazily, every CUDA device's
    torch.manual_seed(seed)
