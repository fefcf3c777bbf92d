"""Distribution: the ('data', 'model') mesh over `torch.distributed`,
table placement, multi-process wiring and collective inspection.

Counterpart of `recbox_tpu/parallel/__init__.py`; ``__all__`` is JAX's
(:12-17), name for name.
"""

from recbox_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, make_mesh, param_partition_specs, replicate_specs,
    shard_batch, shard_params,
)
from recbox_tpu_torch.parallel.placement import (
    TablePlacement, apply_placement, plan_table_placement,
)
from recbox_tpu_torch.parallel.distributed import (
    host_shard_loader, initialize_distributed, process_info,
)

__all__ = [
    "TablePlacement", "apply_placement", "plan_table_placement",
    "DATA_AXIS", "MODEL_AXIS", "make_mesh", "param_partition_specs",
    "replicate_specs", "shard_batch", "shard_params",
    "initialize_distributed", "host_shard_loader", "process_info",
]
