from recbox_tpu_torch.evaluation.ctr import auc_score, log_loss

__all__ = ["auc_score", "log_loss"]
