"""recbox_tpu_torch — the PyTorch/CUDA port of `recbox_tpu`.

The JAX package `recbox_tpu` stays the reference; this package mirrors its
module names (`features.schema`, `nn.embedding`, `retrieval.index`, ...) so
each counterpart is easy to find, and imports nothing of it nor of JAX.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card and without that request they raise
instead of silently dropping to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

__all__ = ["FeatureMap", "FeatureSpec", "Tokenizer", "Normalizer",
           "__version__", "resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is named.

    Raises when no device is named and no CUDA device is present, so a run
    on a machine without a card never measures the CPU by accident."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "recbox_tpu_torch runs on a CUDA device by default and none "
                "is present; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# after resolve_device: modules below the root import it from here
from recbox_tpu_torch.features import (  # noqa: E402
    FeatureMap, FeatureSpec, Normalizer, Tokenizer,
)
