from recbox_tpu_torch.utils.logging import (
    MetricsWriter, profile_step, set_logger,
)
from recbox_tpu_torch.utils.seeding import seed_everything

__all__ = ["MetricsWriter", "profile_step", "set_logger", "seed_everything"]
