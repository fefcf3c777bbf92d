"""Knowledge-aware recommenders (recbole's knowledge_recommender family)."""

from recbox_tpu_torch.models.knowledge.gnn import (
    KGAT, KGCN, KGNNLS, RippleNet, graph_buffer,
)
from recbox_tpu_torch.models.knowledge.intent import KGIN, KSR, MCCLK
from recbox_tpu_torch.models.knowledge.models import CFKG, CKE, KTUP, MKR

__all__ = ["CKE", "CFKG", "KTUP", "MKR", "KGCN", "KGNNLS", "KGAT",
           "RippleNet", "KGIN", "MCCLK", "KSR", "graph_buffer"]
