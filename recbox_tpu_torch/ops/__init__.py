"""Kernels of the port and their plain PyTorch versions (`csrc/` holds the
CUDA sources, `_build.py` builds them at first use).

The public functions of `recbox_tpu/ops/pallas/__init__.py`, plus B5's two
entries. One name differs: `mips_fused_topk` here is the module (its
function is `mips_fused_topk.mips_fused_topk`), since binding the function
over the submodule would hide the module, its launch counts among them.
"""

from recbox_tpu_torch.ops.bitonic_topk import (
    pallas_bitonic_topk, pallas_bitonic_topk_cmajor,
)
from recbox_tpu_torch.ops.embedding_gather import seq_embedding_pool
from recbox_tpu_torch.ops.fused_ce import fused_softmax_ce
from recbox_tpu_torch.ops.mips_topk import pallas_mips_topk

__all__ = ["seq_embedding_pool", "pallas_mips_topk", "fused_softmax_ce",
           "pallas_bitonic_topk", "pallas_bitonic_topk_cmajor"]
