"""Core NN blocks: MLP, activations and the initializers the towers use.

Counterpart of `recbox_tpu/nn/core.py` (`MLP` :69-104, `get_activation`
:54-66). The retrieval slice serves towers in eval mode, so the MLP here
carries Linear → activation → dropout; BatchNorm and Dice are
training-side state and wait for the training slice (they raise here).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MLP", "get_activation", "xavier_normal_", "xavier_uniform_"]

# flax's xavier initializers are variance_scaling(1, 'fan_avg', ...); its
# 'truncated_normal' draws N(0, 1) truncated to [-2, 2] and divides the
# std by that distribution's std, .87962566103423978
_TRUNC_STD = .87962566103423978


def xavier_normal_(t: torch.Tensor, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """flax `xavier_normal()`: truncated normal at fan_avg variance.

    fan_avg = (rows + cols) / 2 of a 2-D tensor, which is the same for a
    flax (in, out) kernel and the transposed torch (out, in) weight."""
    std = math.sqrt(2.0 / (t.shape[0] + t.shape[1])) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def xavier_uniform_(t: torch.Tensor, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """flax `xavier_uniform()`: uniform at fan_avg variance (torch's own
    xavier_uniform_ computes the same bound)."""
    with torch.no_grad():
        return nn.init.xavier_uniform_(t, generator=generator)


_ACTIVATIONS: dict = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": F.leaky_relu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "elu": F.elu,
    "silu": F.silu,
    "swish": F.silu,
    "identity": lambda x: x,
    "linear": lambda x: x,
    "none": lambda x: x,
}


def get_activation(act: Union[str, Callable, None]) -> Callable:
    """String registry of activations, as in the JAX package."""
    if act is None:
        return lambda x: x
    if callable(act):
        return act
    key = act.lower()
    if key == "dice":
        raise ValueError("Dice is stateful; it waits for the training slice")
    if key not in _ACTIVATIONS:
        raise NotImplementedError(f"activation={act}")
    return _ACTIVATIONS[key]


class MLP(nn.Module):
    """[Linear → act → (dropout)]* → optional ``output_dim`` head.

    Layer ``i`` is ``dense[i]``, the counterpart of flax's ``Dense_i``
    (`interop.from_jax_params` maps one onto the other). Weights are flax's
    xavier_normal draw, biases zero.
    """

    def __init__(self, in_dim: int, hidden_units: Sequence[int],
                 activation: Union[str, Sequence[str]] = "relu",
                 output_dim: Optional[int] = None,
                 dropout: Union[float, Sequence[float]] = 0.0,
                 batch_norm: bool = False, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        if batch_norm:
            raise NotImplementedError(
                "MLP(batch_norm=True) waits for the training slice")
        n = len(hidden_units)
        acts = [activation] * n if isinstance(activation, str) \
            else list(activation)
        drops = [dropout] * n if isinstance(dropout, (int, float)) \
            else list(dropout)
        self._acts = [get_activation(a) for a in acts]
        self._drops = drops
        widths = list(hidden_units) + \
            ([output_dim] if output_dim is not None else [])
        self.dense = nn.ModuleList()
        for units in widths:
            lin = nn.Linear(in_dim, units, bias=use_bias, device=device)
            xavier_normal_(lin.weight, generator)
            if use_bias:
                nn.init.zeros_(lin.bias)
            self.dense.append(lin)
            in_dim = units
        self.out_dim = in_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self._acts)
        for i, lin in enumerate(self.dense):
            x = lin(x)
            if i < n:
                x = self._acts[i](x)
                if self._drops[i] > 0:
                    x = F.dropout(x, self._drops[i], training=self.training)
        return x
