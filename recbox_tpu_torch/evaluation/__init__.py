from recbox_tpu_torch.evaluation.ctr import (
    auc_score, auc_torch, evaluate_ctr, grouped_auc, log_loss,
)
from recbox_tpu_torch.evaluation.evaluators import (
    CTREvaluator, MultiTaskEvaluator, RetrievalEvaluator,
)
from recbox_tpu_torch.evaluation.retrieval import (
    evaluate_retrieval, full_sort_topk, parse_metric,
    retrieval_metrics_from_topk, std_gauc,
)

__all__ = ["evaluate_ctr", "auc_score", "log_loss", "grouped_auc",
           "auc_torch", "evaluate_retrieval", "retrieval_metrics_from_topk",
           "parse_metric", "full_sort_topk", "std_gauc", "CTREvaluator",
           "MultiTaskEvaluator", "RetrievalEvaluator"]
