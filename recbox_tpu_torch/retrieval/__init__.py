from recbox_tpu_torch.retrieval.index import (
    BruteForceMIPS, chunked_topk, quantize_int8,
)
from recbox_tpu_torch.retrieval.service import RetrievalService

__all__ = ["BruteForceMIPS", "chunked_topk", "quantize_int8",
           "RetrievalService"]
