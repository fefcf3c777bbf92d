"""Kernels of the port and their plain PyTorch versions (`csrc/` holds the
CUDA sources, `_build.py` builds them at first use).

The losses of `recbox_tpu/ops/__init__.py` (`ops/losses.py`) and the public
functions of `recbox_tpu/ops/pallas/__init__.py`, plus B5's two entries.
One name differs: `mips_fused_topk` here is the module (its
function is `mips_fused_topk.mips_fused_topk`), since binding the function
over the submodule would hide the module, its launch counts among them.
"""

from recbox_tpu_torch.ops.bitonic_topk import (
    pallas_bitonic_topk, pallas_bitonic_topk_cmajor,
)
from recbox_tpu_torch.ops.embedding_gather import seq_embedding_pool
from recbox_tpu_torch.ops.fused_ce import fused_softmax_ce
from recbox_tpu_torch.ops.losses import (
    binary_crossentropy, bpr_loss, cosine_contrastive_loss,
    embedding_reg_loss, full_softmax_loss, get_matching_loss,
    get_ranking_loss, mse_matching_loss, pairwise_logistic_loss,
    pairwise_margin_loss, sigmoid_crossentropy_loss,
    softmax_crossentropy_loss,
)
from recbox_tpu_torch.ops.mips_topk import pallas_mips_topk

__all__ = ["cosine_contrastive_loss", "mse_matching_loss",
           "pairwise_logistic_loss", "pairwise_margin_loss",
           "sigmoid_crossentropy_loss", "softmax_crossentropy_loss",
           "bpr_loss", "binary_crossentropy", "embedding_reg_loss",
           "get_matching_loss", "get_ranking_loss", "full_softmax_loss",
           "seq_embedding_pool", "pallas_mips_topk", "fused_softmax_ce",
           "pallas_bitonic_topk", "pallas_bitonic_topk_cmajor"]
