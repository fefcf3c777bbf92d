"""MIPS segment candidates: the CUDA kernel, its plain PyTorch version, the
wrappers, and the constants, block plan and id layout every segment-winner
kernel shares.

Port of the TPU kernel `recbox_tpu/ops/pallas/mips_topk.py`
(`mips_segment_candidates` :269, `pallas_mips_topk` :351; constants and
plan :89-114). A corpus is cut into sub-chunks of ``sub_rows`` rows.
Inside one, segment g (0 <= g < n_seg = sub_rows / SEGMENT) is the STRIDED
row set {g, g + n_seg, ..., g + (SEGMENT-1)·n_seg}; each segment gives one
winner per query. Packed, the winner's position in the segment (7 bits)
rides the low mantissa bits of its f32 score; unpacked, the winner is a
score and a global row id.

The kernel (`csrc/mips_topk.cu`, built by `ops/_build.py`) runs for CUDA
tensors, `mips_segment_candidates_plain` for CPU tensors; a CUDA tensor
never reaches the plain version, and a failed build or launch raises. The
kernel has three routes, chosen by `candidate_route` from the dtype, the
depth, the plan and the variant: `wgmma` (bf16 and int8, D = 64 or 128,
n_seg in {1, 2, 4, 8}: TMA-fed `wgmma` with the segment fold in registers),
`segment` (the same types and depths, packed, any other n_seg: the plans
of 910 queries or fewer; TMA brings whole segments through the 3-D view of
`segment_view`) and `tile` (every other case: WMMA / CUDA-core tiles
through a shared score stage). B3's stage (a) (`mips_fused_topk.py`)
launches the packed kernel through `_candidates_cuda`.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from recbox_tpu_torch.ops import _build
from recbox_tpu_torch.ops.bitonic_topk import exact_topk, row_topk
from recbox_tpu_torch.utils import tracing

__all__ = ["SEGMENT", "PACK_FLOOR", "PACK_BITS", "PACK_MASK", "block_plan",
           "candidate_plan", "split_runs", "quantize_int8", "winner_ids",
           "decode_winners", "mips_segment_candidates",
           "mips_segment_candidates_plain",
           "pallas_mips_topk", "candidate_route", "SegmentView",
           "segment_view", "segment_view_row", "launches", "route_launches",
           "reset_launches"]

SEGMENT = 128          # items per candidate segment (one winner each)

# Finite stand-in for -inf in the packed scores: packing an index into an
# infinity's mantissa would make a NaN. Any score at or below -PACK_FLOOR
# is a masked pad row.
PACK_FLOOR = 3.0e38
PACK_BITS = 7                       # log2(SEGMENT): index bits packed
PACK_MASK = (1 << PACK_BITS) - 1

# kernel launches on the CUDA path, by variant and by route; the plain
# version never counts
launches = tracing.register("mips_topk.launches",
                            {"packed": 0, "packed_int8": 0, "unpacked": 0})
route_launches = tracing.register("mips_topk.route_launches",
                                  {"wgmma": 0, "segment": 0, "tile": 0})

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _all_pad_winner() -> float:
    """The packed winner of a segment of pad rows: -PACK_FLOOR with index
    0, the float max of its packed rows."""
    bits = struct.unpack("<i", struct.pack("<f", -PACK_FLOOR))[0]
    return struct.unpack("<f", struct.pack("<i", bits & ~PACK_MASK))[0]


ALL_PAD_WINNER = _all_pad_winner()


def reset_launches() -> None:
    for counts in (launches, route_launches):
        for name in counts:
            counts[name] = 0


def block_plan(itemsize: int, qt: int, d: int) -> Tuple[int, int]:
    """(sub_rows, subs_per_block) of the JAX kernels for a query tile of
    ``qt`` rows over a corpus of ``itemsize``-byte values, ``d`` wide after
    padding to 128 (`mips_topk.py:100-114`). The TPU sized both to its
    4 MB VMEM block budget; the port keeps the plan because it decides the
    segments, and so which candidates exist."""
    block_budget = 4 * (1 << 20)
    row_bytes = d * itemsize
    sub_rows = max(SEGMENT, min((1 << 20) // max(qt, 1),
                                block_budget // row_bytes))
    sub_rows = max(SEGMENT, (sub_rows // SEGMENT) * SEGMENT)
    spb = max(1, block_budget // (row_bytes * sub_rows))
    return sub_rows, spb


def candidate_plan(corpus_dtype: torch.dtype, n: int, d: int, qt: int
                   ) -> Tuple[int, int]:
    """(sub_rows, candidates) of the JAX candidate kernel for a query tile
    of ``qt`` rows over an (n, d) corpus: one candidate per 128 rows of the
    corpus padded to its grid block of sub_rows · subs_per_block rows
    (`mips_topk.py:292-297`, `:408-410`)."""
    itemsize = torch.empty((), dtype=corpus_dtype).element_size()
    sub_rows, spb = block_plan(itemsize, qt, d + (-d) % 128)
    c_block = sub_rows * spb
    return sub_rows, -(-n // c_block) * c_block // SEGMENT


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


def decode_winners(vals: torch.Tensor, pos: torch.Tensor, sub_rows: int,
                   q_scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores f32, ids int32) of selected packed winners ``vals`` (Q, k)
    at candidate positions ``pos``: the index bits cleared, the global row
    rebuilt (`winner_ids`), scores times the per-query ``q_scale`` (int8);
    a winner at or below -PACK_FLOOR / 2 (a segment of pad rows) becomes
    the shared pad (-inf, -1)."""
    bits = vals.view(torch.int32)
    clean = (bits & ~PACK_MASK).view(torch.float32)
    ids = winner_ids(pos.to(torch.int64), (bits & PACK_MASK).to(torch.int64),
                     sub_rows)
    alive = clean > -PACK_FLOOR / 2
    if q_scale is not None:
        clean = clean * q_scale[:, None]
    return (torch.where(alive, clean, float("-inf")),
            torch.where(alive, ids, -1).to(torch.int32))


def _segment_base(n_sub: int, sub_rows: int, device) -> torch.Tensor:
    """(n_sub · n_seg,) first row of each candidate's segment: the id JAX
    gives the winner of a segment of pad rows (argmax 0)."""
    n_seg = sub_rows // SEGMENT
    return (torch.arange(n_sub, device=device)[:, None] * sub_rows
            + torch.arange(n_seg, device=device)[None, :]).reshape(-1)


def mips_segment_candidates_plain(queries: torch.Tensor,
                                  corpus: torch.Tensor, valid: int,
                                  packed: bool, row_scale=None,
                                  sub_rows: int = 1024):
    """The kernel's function in plain PyTorch over the ceil(N / sub_rows)
    sub-chunks that hold corpus rows: candidate-major (n_seg · n_sub, Q)
    packed f32 winners, or (scores f32, ids int32) unpacked.

    Queries have the corpus's dtype. bf16 inputs are upcast and multiplied
    in f32, which equals bf16 × bf16 products summed in f32; int8 rows are
    exact integers in f32 while D·127² < 2^24, else in f64. On the card it
    needs ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    n, nq = corpus.shape[0], queries.shape[0]
    dev = corpus.device
    n_seg = sub_rows // SEGMENT
    n_sub = -(-n // sub_rows)
    n_pad = n_sub * sub_rows
    wide = corpus.dtype == torch.int8 and corpus.shape[1] * 127 * 127 >= 2**24
    work = torch.float64 if wide else torch.float32
    cf = F.pad(corpus.to(work), (0, 0, 0, n_pad - n))
    live = torch.arange(n_pad, device=dev) < valid
    scale = None
    if row_scale is not None:
        scale = F.pad(row_scale.to(torch.float32), (0, n_pad - n), value=1.0)
    idx = torch.arange(SEGMENT, dtype=torch.int32, device=dev)
    idx = idx.view(1, 1, SEGMENT, 1)
    base = _segment_base(n_sub, sub_rows, dev)
    out_s = torch.empty((n_sub * n_seg, nq), dtype=torch.float32, device=dev)
    out_i = None if packed else torch.empty((n_sub * n_seg, nq),
                                            dtype=torch.int32, device=dev)
    # a (step, n_pad) score block of 2^24 elements on the CPU, 2^27 on a card
    step = max(1, (2**24 if dev.type == "cpu" else 2**27) // n_pad)
    for q0 in range(0, nq, step):
        s = (queries[q0:q0 + step].to(work) @ cf.T).to(torch.float32)
        m = s.shape[0]
        if scale is not None:
            s = s * scale
        if packed:
            s = torch.clamp(s, -PACK_FLOOR, PACK_FLOOR)
            s = torch.where(live, s, -PACK_FLOOR)
            bits = s.view(torch.int32).view(m, n_sub, SEGMENT, n_seg)
            win = torch.amax(((bits & ~PACK_MASK) | idx).view(torch.float32),
                             dim=2)
        else:
            s = torch.where(live, s, float("-inf"))
            # torch.max returns the first index of the max, as jnp.argmax
            win, arg = torch.max(s.view(m, n_sub, SEGMENT, n_seg), dim=2)
            ids = base + arg.reshape(m, -1) * n_seg
            out_i[:, q0:q0 + m] = ids.T.to(torch.int32)
        out_s[:, q0:q0 + m] = win.reshape(m, -1).T
    return out_s if packed else (out_s, out_i)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("mips_topk")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.recbox_mips_segment_candidates.argtypes = [i, i, vp, vp, vp, vp, vp,
                                                   i, i, i, i, i, i, vp]
    lib.recbox_mips_segment_candidates.restype = i
    lib.recbox_mips_segment_candidates_wgmma.argtypes = [i, i, vp, vp, vp, vp,
                                                         vp, i, i, i, i, i,
                                                         vp]
    lib.recbox_mips_segment_candidates_wgmma.restype = i
    ll = ctypes.c_longlong
    lib.recbox_mips_segment_candidates_segment.argtypes = [
        i, vp, vp, vp, vp, i, i, i, i, i, ll, ll, ll, i, i, vp]
    lib.recbox_mips_segment_candidates_segment.restype = i
    return lib


# the depths and segment counts the wgmma route is built for; the segment
# route takes the same depths and every other segment count of a plan
_WGMMA_DEPTHS = (64, 128)
_WGMMA_SEGMENTS = (1, 2, 4, 8)


def candidate_route(dtype: torch.dtype, d: int, sub_rows: int,
                    packed: bool = True) -> str:
    """The kernel's route for a corpus of ``dtype`` and depth ``d`` at the
    plan with ``sub_rows``: for bf16 and int8 with D = 64 or 128 (after
    padding to 16), 'wgmma' where n_seg = sub_rows / 128 is in {1, 2, 4, 8}
    (every row a thread of the `wgmma` tile holds is in one segment: the
    plans of 911 queries or more) and 'segment' for the packed variants at
    every other n_seg (the plans of 910 queries or fewer, 9 to 256
    segments); 'tile' for the rest (f32, which TF32 would change; other
    depths; the unpacked variant off the `wgmma` plans). B3's stage (a),
    packed, takes the same rule."""
    if (dtype in (torch.bfloat16, torch.int8)
            and d + (-d) % 16 in _WGMMA_DEPTHS
            and sub_rows % SEGMENT == 0):
        if sub_rows // SEGMENT in _WGMMA_SEGMENTS:
            return "wgmma"
        if packed:
            return "segment"
    return "tile"


class SegmentView(NamedTuple):
    """How the segment route's TMA sees an (n, d) corpus: as a 3-D
    (d, n_seg, seg_rows) array whose element (k, g, j) is value k of row
    j·n_seg + g, so that a box of 128 consecutive j at one g is one whole
    segment (segment g of sub-chunk s is j = s·128 ... s·128 + 127). The
    view reaches rows < seg_rows·n_seg = rows - tail_segs; the last
    tail_segs rows (index seg_rows... of segments g < tail_segs of sub-chunk
    tail_sub) come from the same view shifted by tail_segs rows, read there
    at (g - tail_segs + n_seg, s·128 - 1). A corpus of fewer rows than a
    sub-chunk that is not a whole number of n_seg rows is padded with
    pad_rows zero rows first (a copy of under sub_rows rows)."""
    n_seg: int
    rows: int                   # corpus rows the kernel sees (n + pad_rows)
    pad_rows: int
    dims: Tuple[int, int, int]  # (d, n_seg, seg_rows), innermost first
    strides: Tuple[int, int]    # bytes of a step in g and in j
    tail_sub: int               # -1 when tail_segs is 0
    tail_segs: int


def segment_view(n: int, d: int, itemsize: int, sub_rows: int
                 ) -> SegmentView:
    """The segment route's view of an (n, d) corpus of ``itemsize``-byte
    values at the plan with ``sub_rows`` (`SegmentView`); the wrapper pads
    and launches by it."""
    n_seg = sub_rows // SEGMENT
    pad = (-n) % n_seg if n < sub_rows else 0
    rows = n + pad
    tail_segs = rows % n_seg
    return SegmentView(n_seg, rows, pad, (d, n_seg, rows // n_seg),
                       (d * itemsize, n_seg * d * itemsize),
                       rows // sub_rows if tail_segs else -1, tail_segs)


def segment_view_row(view: SegmentView, sub: int, g: int, i: int) -> int:
    """The corpus row that the segment route's box brings as index ``i`` of
    segment ``g`` of sub-chunk ``sub``, or -1 where TMA fills zeros (a row
    at or past ``view.rows``); the kernel's producer takes the same
    coordinates."""
    n_seg, seg_rows = view.n_seg, view.dims[2]
    if sub == view.tail_sub and g < view.tail_segs:
        base, g, j = view.tail_segs, g - view.tail_segs + n_seg, \
            sub * SEGMENT - 1 + i
    else:
        base, j = 0, sub * SEGMENT + i
    return base + j * n_seg + g if 0 <= j < seg_rows else -1


# queries a block of the kernel scores (QT in csrc/mips_tile.cuh)
_QUERY_TILE = 64


def split_runs(nq: int, n: int, sub_rows: int, packed: bool, device) -> int:
    """Runs the kernel splits each sub-chunk's 128-row chunks into: a grid
    of fewer than two blocks per SM takes more than one, merged by an
    atomic float max into winners at -inf. Packed only; the unpacked
    variant keeps its first-index rule by running whole sub-chunks."""
    if not packed:
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = -(-nq // _QUERY_TILE) * -(-n // sub_rows)
    return min(sub_rows // SEGMENT, -(-2 * sms // blocks))


def _candidates_cuda(queries, corpus, valid, packed, row_scale, sub_rows,
                     out_s, out_i) -> str:
    """Launch the kernel into the first ceil(N / sub_rows) · n_seg rows of
    the candidate-major ``out_s`` (and ``out_i``); returns the route it
    took."""
    dev = corpus.device
    if not (corpus.is_cuda and queries.device == dev):
        raise ValueError(f"mips_segment_candidates: queries on "
                         f"{queries.device}, corpus on {dev}; the kernel "
                         "takes both on one CUDA device")
    d_pad = (-corpus.shape[1]) % 16
    if d_pad:   # the kernel loads 16-byte vectors along the depth
        corpus = F.pad(corpus, (0, d_pad))
        queries = F.pad(queries, (0, d_pad))
    queries, corpus = queries.contiguous(), corpus.contiguous()
    nq, (n, d) = queries.shape[0], corpus.shape
    n_sub = -(-n // sub_rows)
    if n_sub > 65535:
        raise ValueError(f"mips_segment_candidates: {n} rows exceed the "
                         f"kernel's {65535 * sub_rows} at sub_rows={sub_rows}")
    route = candidate_route(corpus.dtype, d, sub_rows, packed)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out_i_ptr = None if out_i is None else out_i.data_ptr()
    if row_scale is not None:
        row_scale = row_scale.to(device=dev, dtype=torch.float32).contiguous()
    scale_ptr = None if row_scale is None else row_scale.data_ptr()
    if route == "wgmma":
        with torch.cuda.device(dev):
            rc = lib.recbox_mips_segment_candidates_wgmma(
                _DTYPES[corpus.dtype], int(packed), queries.data_ptr(),
                corpus.data_ptr(), scale_ptr, out_s.data_ptr(), out_i_ptr,
                nq, n, d, valid, sub_rows, stream)
    elif route == "segment":
        view = segment_view(n, d, corpus.element_size(), sub_rows)
        if view.pad_rows:   # under one sub-chunk: a copy of < sub_rows rows
            corpus = F.pad(corpus, (0, 0, 0, view.pad_rows))
            if row_scale is not None:
                row_scale = F.pad(row_scale, (0, view.pad_rows), value=1.0)
                scale_ptr = row_scale.data_ptr()
        with torch.cuda.device(dev):
            rc = lib.recbox_mips_segment_candidates_segment(
                _DTYPES[corpus.dtype], queries.data_ptr(), corpus.data_ptr(),
                scale_ptr, out_s.data_ptr(), nq, view.rows, d, valid,
                sub_rows, view.dims[2], *view.strides, view.tail_sub,
                view.tail_segs, stream)
    else:
        splits = split_runs(nq, n, sub_rows, packed, dev)
        if splits > 1:
            out_s[:n_sub * (sub_rows // SEGMENT)].fill_(float("-inf"))
        with torch.cuda.device(dev):
            rc = lib.recbox_mips_segment_candidates(
                _DTYPES[corpus.dtype], int(packed), queries.data_ptr(),
                corpus.data_ptr(), scale_ptr, out_s.data_ptr(), out_i_ptr,
                nq, n, d, valid, sub_rows, splits, stream)
    if rc != 0:
        raise RuntimeError(f"mips_segment_candidates: {route} launch failed "
                           f"with CUDA error {rc}")
    variant = "unpacked" if not packed else (
        "packed_int8" if corpus.dtype == torch.int8 else "packed")
    launches[variant] += 1
    route_launches[route] += 1
    return route


def _candidates(queries, corpus, valid, packed, row_scale, sub_rows,
                n_cand):
    """Candidate-major (n_cand, Q) winners of the plan with ``sub_rows``:
    the kernel (CUDA) or the plain version (CPU) over the sub-chunks that
    hold corpus rows, then the all-pad segments of JAX's padded grid block,
    which are never computed: packed, ALL_PAD_WINNER; unpacked, -inf with
    the segment's first row as id, as JAX's argmax gives them."""
    dev, nq = corpus.device, queries.shape[0]
    n_live = -(-corpus.shape[0] // sub_rows) * (sub_rows // SEGMENT)
    if dev.type == "cpu":
        got = mips_segment_candidates_plain(queries, corpus, valid, packed,
                                            row_scale, sub_rows)
        live_s, live_i = (got, None) if packed else got
        out_s = torch.cat([live_s, live_s.new_empty((n_cand - n_live, nq))])
        out_i = None if packed else torch.cat(
            [live_i, live_i.new_empty((n_cand - n_live, nq))])
    else:
        out_s = torch.empty((n_cand, nq), dtype=torch.float32, device=dev)
        out_i = None if packed else torch.empty((n_cand, nq),
                                                dtype=torch.int32, device=dev)
        if nq:
            _candidates_cuda(queries, corpus, valid, packed, row_scale,
                             sub_rows, out_s, out_i)
    if packed:
        out_s[n_live:] = ALL_PAD_WINNER
        return out_s
    out_s[n_live:] = float("-inf")
    n_sub = n_cand * SEGMENT // sub_rows
    out_i[n_live:] = _segment_base(n_sub, sub_rows, dev)[n_live:, None]
    return out_s, out_i


def _check_corpus(queries, corpus, row_scale, who):
    if corpus.dtype not in _DTYPES:
        raise TypeError(f"{who}: corpus dtype {corpus.dtype}; expected "
                        "float32, bfloat16 or int8")
    if queries.ndim != 2 or corpus.ndim != 2 \
            or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"{who}: queries {tuple(queries.shape)} vs corpus "
                         f"{tuple(corpus.shape)}")
    if row_scale is not None:
        row_scale = row_scale.reshape(-1)
        if row_scale.shape[0] != corpus.shape[0]:
            raise ValueError(f"row_scale has {row_scale.shape[0]} entries "
                             f"for a {corpus.shape[0]}-row corpus")
    return row_scale


def mips_segment_candidates(queries: torch.Tensor, corpus: torch.Tensor,
                            valid_items: Optional[int] = None,
                            packed: bool = False,
                            row_scale: Optional[torch.Tensor] = None
                            ) -> Union[torch.Tensor,
                                       Tuple[torch.Tensor, torch.Tensor]]:
    """Candidate-major (n_candidates, Qt) segment winners of ``corpus`` for
    the query tile ``queries`` (Qt, D): packed f32 scores (low 7 mantissa
    bits the in-segment index, pads near -PACK_FLOOR), or, with
    ``packed=False``, (scores f32, global ids int32), pads -inf.

    The segment plan is JAX's for a tile of Qt queries. JAX wants N a
    multiple of its grid block and D of 128; here any N and D go, the
    candidates are counted over N padded to the grid block as JAX counts
    them, and rows >= N are padding. ``valid_items`` (default N) marks rows
    >= it as padding too. Float queries are cast to the corpus's dtype; an
    int8 corpus takes int8 queries and its per-row ``row_scale`` (N,) or
    (N, 1), packed only. Global ids of packed winners come from
    `winner_ids`; `pallas_mips_topk` does this. JAX's ``interpret`` picks a
    JAX implementation and has no counterpart.
    """
    who = "mips_segment_candidates"
    row_scale = _check_corpus(queries, corpus, row_scale, who)
    if (corpus.dtype == torch.int8) != (row_scale is not None):
        raise ValueError("an int8 corpus takes row_scale (the quantize_int8 "
                         "per-row scales), and only an int8 corpus does")
    if row_scale is not None:
        if not packed:
            raise ValueError("row_scale (int8 corpus) implies the packed "
                             "kernel")
        if queries.dtype != torch.int8:
            raise TypeError(f"{who}: an int8 corpus takes int8 queries, got "
                            f"{queries.dtype}")
    else:
        queries = queries.to(corpus.dtype)
    n, nq = corpus.shape[0], queries.shape[0]
    sub_rows, n_cand = candidate_plan(corpus.dtype, n, corpus.shape[1],
                                      max(nq, 1))
    valid = n if valid_items is None else min(int(valid_items), n)
    return _candidates(queries, corpus, valid, packed, row_scale, sub_rows,
                       n_cand)


def _too_many(k, n_cand, n, tail=True):
    msg = (f"pallas_mips_topk: k={k} exceeds the {n_cand} segment candidates "
           f"for a {n}-row corpus")
    if tail:
        msg += "; use the 'segmented'/'approx' XLA paths for k this large"
    return ValueError(msg)


def pallas_mips_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     valid_items: Optional[int] = None,
                     exact_merge: bool = False, merge: Optional[str] = None,
                     packed: Optional[bool] = None, query_tile: int = 1024,
                     row_scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (scores (Q, k) f32, ids (Q, k) int32) over the corpus through
    the segment-candidate kernel and one merge; slots past the live
    candidates are (-inf, -1).

    JAX's signature (minus ``interpret``) and checks. ``query_tile`` sets
    the segment plan (a tile of min(query_tile, Q) queries); JAX swept the
    tiles one by one, here one launch covers every query, with the same
    candidates. ``packed`` (default: on, except under ``merge='bitonic'``)
    picks the packed-mantissa kernel, whose scores carry the 2^-17
    truncation. An int8 corpus (`quantize_int8` rows and their
    ``row_scale``) is packed-only: queries are quantized per row and the
    per-query scale is applied to the k winners. Float queries are cast to
    the corpus's dtype.

    The merge: JAX takes `lax.top_k` when ``exact_merge`` or the candidates
    are at most 2k, else `approx_max_k(0.95)`; both branches here are one
    exact top-k in plain PyTorch in the port's total order (score
    descending, candidate position ascending), so the two give the same
    result. ``merge='bitonic'`` (unpacked only) runs the B5 kernel
    (`ops/bitonic_topk.py`) on the candidate-major arrays in place.
    """
    int8_corpus = corpus.dtype == torch.int8
    if int8_corpus:
        if row_scale is None:
            raise ValueError("int8 corpus requires row_scale (the "
                             "quantize_int8 per-row scales)")
        if packed is False or merge == "bitonic":
            raise ValueError("the int8 corpus path is packed-only")
        packed = True
    elif row_scale is not None:
        raise ValueError("row_scale is only meaningful for an int8 corpus")
    if packed is None:
        packed = merge != "bitonic"
    if packed and merge == "bitonic":
        raise ValueError("merge='bitonic' consumes the explicit-id "
                         "candidate layout; pass packed=False")
    row_scale = _check_corpus(queries, corpus, row_scale, "pallas_mips_topk")
    n = corpus.shape[0]
    n_items = n if valid_items is None else int(valid_items)
    nq = queries.shape[0]
    qt = min(query_tile, max(nq, 1))
    sub_rows, n_cand = candidate_plan(corpus.dtype, n, corpus.shape[1], qt)
    if k > n_cand:
        raise _too_many(k, n_cand, n, tail=merge != "bitonic")
    q_scale = None
    if int8_corpus:
        queries, q_scale = quantize_int8(queries)
    else:
        queries = queries.to(corpus.dtype)
    # the tile's plan for every query at once: the candidates JAX's sweep
    # of the tiles gives
    cands = functools.partial(_candidates, queries, corpus, min(n_items, n),
                              row_scale=row_scale, sub_rows=sub_rows,
                              n_cand=n_cand)
    if packed:
        vals, pos = exact_topk(cands(packed=True).T, k)
        return decode_winners(vals, pos, sub_rows, q_scale)
    cs, ci = cands(packed=False)
    if merge == "bitonic":
        ts, ti = row_topk(cs.T, ci.T, k)
        return ts, torch.where(torch.isfinite(ts), ti, -1)
    # pad rows were scored -inf in the kernel; this only normalizes the
    # all-pad segments' winners
    cs = torch.where(ci < n_items, cs, float("-inf"))
    top_s, pos = exact_topk(cs.T, k)
    top_i = torch.gather(ci.T, 1, pos)
    return top_s, torch.where(torch.isfinite(top_s), top_i, -1)
