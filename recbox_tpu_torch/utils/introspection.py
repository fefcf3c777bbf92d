"""Model/environment introspection.

Own copy of `recbox_tpu/utils/introspection.py` over torch (recbole's
`get_flops` / `get_environment`, `third_party/recbole/utils/utils.py:
250-430`). The keys differ from JAX's where the backends do
(`ROADMAP.md` Queue C):

* `estimate_cost` counts FLOPs with `torch.utils.flop_counter` over one
  call of ``fn`` (matmuls, convolutions and attention; elementwise work is
  not counted), where JAX reads XLA's cost analysis of the compiled
  program. ``bytes_accessed`` and ``optimal_seconds`` come back 0.0, as
  JAX's docstring allows for keys a backend lacks.
* `get_environment` names ``torch`` where JAX names ``jax``, its backend
  is ``cuda`` or ``cpu``, and ``device_kind`` is the card's name.
* `get_device_memory` reads `torch.cuda.memory_stats` (the caching
  allocator's bytes, not all the card's memory in use); ``{}`` on the CPU,
  as JAX's is there.
"""

from __future__ import annotations

import platform
from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ["estimate_cost", "count_params", "get_environment",
           "get_device_memory"]


def estimate_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once under torch's FLOP counter:
    {'flops', 'bytes_accessed', 'optimal_seconds'} (the last two 0.0)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": 0.0, "optimal_seconds": 0.0}


def count_params(params: Any) -> int:
    """Total parameter count of a module, a state dict or a nested
    mapping / sequence of arrays or tensors."""
    if isinstance(params, torch.nn.Module):
        return int(sum(p.numel() for p in params.parameters()))
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    if hasattr(params, "shape"):
        return int(np.prod(params.shape))
    return 0


def get_environment() -> Dict[str, str]:
    """Runtime environment table (recbole get_environment analog)."""
    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 1
    return {
        "python": platform.python_version(),
        "torch": torch.__version__,
        "backend": "cuda" if cuda else "cpu",
        "num_devices": str(n),
        "device_kind": (torch.cuda.get_device_name(0) if cuda
                        else platform.processor() or platform.machine()),
        "host_count": "1",
    }


def get_device_memory(device=None) -> Dict[str, float]:
    """Device memory stats in GiB (recbole get_gpu_usage analog); empty dict
    on the CPU."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    gib = 1024 ** 3
    out = {"in_use_gib": stats.get("allocated_bytes.all.current", 0) / gib,
           "limit_gib": torch.cuda.get_device_properties(dev).total_memory
           / gib,
           "peak_gib": stats.get("allocated_bytes.all.peak", 0) / gib}
    return out
