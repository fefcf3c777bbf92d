from recbox_tpu_torch.models.ranking.ctr import DeepFM

__all__ = ["DeepFM"]
