"""flax's ``GRUCell`` and the scan of ``nn.RNN`` over it.

Counterpart of `flax.linen.GRUCell` and `flax.linen.RNN`, as the JAX
package's recurrent models use them (`recbox_tpu/models/sequential/
models.py:173-230` GRU4Rec and NARM, `extended.py:672` RepeatNet,
`session_graph.py:79` the GGNN's step, `models/reranking/models.py:84`
DLCM, `models/ranking/sequence_ctr.py` DSIN, `models/reranking/rl.py` the
EGR models). The cell:

    r = σ(ir(x) + hr(h)),  z = σ(iz(x) + hz(h)),
    n = tanh(in(x) + r · hn(h)),  h' = (1 − z) · n + z · h,

a bias on the three input projections and on ``hn`` only (flax's names,
which `interop.from_jax_params` fills), lecun-normal input kernels and
orthogonal recurrent ones. ``torch.nn.GRU`` carries trainable biases on
the r and z recurrent projections too, which an optimizer would move apart
from JAX's model, so the cell is written out. `rnn` is ``nn.RNN``: a zero
carry scanned over every position of the (B, L, D) input, padding
included, the states of all L steps returned; the input projections run
once over the whole sequence before the loop. With ``lengths`` and
``reverse`` it is ``nn.RNN(cell, reverse=True, keep_order=True)(x,
seq_lengths=lengths)``: each row's valid prefix reversed and its padding
reversed after it (`flip_sequences`), scanned, and flipped back. flax's
``seq_lengths`` selects nothing in the outputs: every slot, padding
included, holds the state the scan reached there, and so does the port's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from recbox_tpu_torch.nn.attention import dense

__all__ = ["GRUCell", "rnn", "flip_sequences", "take_steps"]


class GRUCell(nn.Module):
    """One flax ``GRUCell`` of ``hidden`` units over ``in_dim``-wide
    inputs; ``cell(h, x)`` is one step, `rnn` the scan."""

    def __init__(self, in_dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, dense(in_dim, hidden, generator, device))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            lin = nn.Linear(hidden, hidden, bias=bias, device=device)
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, generator=generator)
            if bias:
                nn.init.zeros_(lin.bias)
            self.add_module(name, lin)
        self.hidden = hidden

    def inputs(self, x: torch.Tensor):
        """The three input projections of ``x`` (any leading shape)."""
        return self.ir(x), self.iz(x), getattr(self, "in")(x)

    def step(self, h: torch.Tensor, xr: torch.Tensor, xz: torch.Tensor,
             xn: torch.Tensor) -> torch.Tensor:
        """The new carry from ``h`` and projected inputs."""
        r = torch.sigmoid(xr + self.hr(h))
        z = torch.sigmoid(xz + self.hz(h))
        n = torch.tanh(xn + r * self.hn(h))
        return (1.0 - z) * n + z * h

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One step: flax's ``cell(carry, inputs)``, the new carry."""
        return self.step(h, *self.inputs(x))


def take_steps(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, t]]`` over (B, S, D): a per-row reordering of steps."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def flip_sequences(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """flax's ``flip_sequences`` over (B, S, D): each row's first
    ``length`` steps reversed and its padding reversed after them, index
    (S − 1 − t + length) mod S."""
    s = x.shape[1]
    idx = (torch.arange(s - 1, -1, -1, device=x.device)[None, :]
           + lengths.to(torch.int64)[:, None]) % s
    return take_steps(x, idx)


def rnn(cell: GRUCell, x: torch.Tensor,
        lengths: Optional[torch.Tensor] = None,
        reverse: bool = False) -> torch.Tensor:
    """flax ``nn.RNN(cell)(x)``: (B, L, D) → the (B, L, H) states from a
    zero carry over all L steps. ``reverse``: flax's ``reverse=True,
    keep_order=True``, over each row's first ``lengths`` steps reversed
    (all L steps without ``lengths``), the states put back in the input's
    order."""
    if reverse:
        flip = (lambda t: torch.flip(t, dims=(1,))) if lengths is None \
            else (lambda t: flip_sequences(t, lengths))
        return flip(rnn(cell, flip(x)))
    xr, xz, xn = cell.inputs(x)
    h = torch.zeros(x.shape[0], cell.hidden, dtype=xr.dtype,
                    device=x.device)
    out = []
    for t in range(x.shape[1]):
        h = cell.step(h, xr[:, t], xz[:, t], xn[:, t])
        out.append(h)
    return torch.stack(out, dim=1)
