from recbox_tpu_torch.retrieval.index import (
    BruteForceMIPS, approx_mips_topk, chunked_topk, int8_mips_topk,
    quantize_int8, segmented_mips_topk,
)
from recbox_tpu_torch.retrieval.service import RetrievalService

__all__ = ["BruteForceMIPS", "approx_mips_topk", "chunked_topk",
           "segmented_mips_topk", "int8_mips_topk", "quantize_int8",
           "RetrievalService"]
