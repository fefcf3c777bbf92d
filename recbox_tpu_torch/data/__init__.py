from recbox_tpu_torch.data.loader import MASK_KEY, ArrayLoader

__all__ = ["ArrayLoader", "MASK_KEY"]
