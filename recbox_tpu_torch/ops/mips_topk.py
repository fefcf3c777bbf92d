"""Constants and id layout of the packed-mantissa MIPS kernels.

Own copy of what `recbox_tpu/ops/pallas/mips_topk.py` defines for every
segment-winner kernel (:89-114, :285-287, :455-456). The candidate kernel
itself (`pallas_mips_topk`, `mips_segment_candidates`) waits for slice 2.

A corpus is cut into sub-chunks of ``sub_rows`` rows. Inside one, segment
g (0 <= g < n_seg = sub_rows / SEGMENT) is the STRIDED row set
{g, g + n_seg, ..., g + (SEGMENT-1)·n_seg}; each segment gives one winner
per query, whose position in the segment (7 bits) rides the low mantissa
bits of its f32 score.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["SEGMENT", "PACK_FLOOR", "PACK_BITS", "PACK_MASK", "quantize_int8",
           "winner_ids"]

SEGMENT = 128          # items per candidate segment (one winner each)

# Finite stand-in for -inf in the packed scores: packing an index into an
# infinity's mantissa would make a NaN. Any score at or below -PACK_FLOOR
# is a masked pad row.
PACK_FLOOR = 3.0e38
PACK_BITS = 7                       # log2(SEGMENT): index bits packed
PACK_MASK = (1 << PACK_BITS) - 1


def quantize_int8(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization: (N, D) float → (int8 rows, f32
    row scales), `recbox_tpu/retrieval/index.py:48-56`. The corpus is
    quantized with it once, the queries on every search."""
    rows = rows.to(torch.float32)
    amax = torch.amax(torch.abs(rows), dim=1)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(rows / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def winner_ids(cand: torch.Tensor, idx: torch.Tensor, sub_rows: int
               ) -> torch.Tensor:
    """Global row of a winner from its candidate position ``cand``
    (sub-chunk · n_seg + segment) and its packed in-segment index ``idx``."""
    n_seg = sub_rows // SEGMENT
    return (cand // n_seg) * sub_rows + cand % n_seg + idx * n_seg
