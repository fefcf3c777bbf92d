from recbox_tpu_torch.models.multitask.models import (
    AITM, ESMM, MMOE, PLE, SharedBottom, multitask_loss,
)

__all__ = ["SharedBottom", "MMOE", "PLE", "ESMM", "AITM", "multitask_loss"]
