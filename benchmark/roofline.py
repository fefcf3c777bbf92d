"""The yardstick's arithmetic: the H100's published peaks, and the operations
and bytes that each measured kernel and model step needs, computed from
shapes and inputs. The counts are of the work, so they read the same
whatever implements it.

A kernel's bound is the larger of its operations over the peak of its type
and its bytes over the HBM rate, each input byte read once and each output
byte written once; where the work depends on the data (B1's distinct rows),
the count is of what these inputs need.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA H100 SXM data sheet: dense rates without sparsity, at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "int8": 1979e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BYTES_S = 3.35e12

_ITEMSIZE = {"bfloat16": 2, "int8": 1, "float32": 4}


def bound_s(ops: float, peak: float, moved: float) -> Tuple[float, str]:
    """(least seconds, what bounds them) of ``ops`` operations at ``peak``
    and ``moved`` bytes at the HBM rate."""
    by_ops, by_bytes = ops / peak, moved / HBM_BYTES_S
    return (by_ops, "operations") if by_ops >= by_bytes \
        else (by_bytes, "bytes")


def mips_topk_bound_s(n: int, d: int, q: int, k: int,
                      dtype: str = "bfloat16") -> Tuple[float, str]:
    """B3, the fused MIPS top-k: the (n, d) corpus and (q, d) queries read
    once in ``dtype`` (an int8 corpus with its f32 row scales), (q, k) f32
    scores and int32 ids written once; 2·q·n·d operations at the type's
    peak."""
    moved = (n * d + q * d) * _ITEMSIZE[dtype] + q * k * 8
    if dtype == "int8":
        moved += n * 4
    return bound_s(2.0 * q * n * d, PEAK_FLOPS[dtype], moved)


def select_bytes(rows: int, c: int, k: int, with_ids: bool) -> int:
    """B5 over (rows, c) f32 scores (and int32 ids): every key read once,
    the k winners a row written once as f32 score and int32 id."""
    return rows * c * (8 if with_ids else 4) + rows * k * 8


def select_bound_s(rows: int, c: int, k: int, with_ids: bool = False
                   ) -> Tuple[float, str]:
    return bound_s(0.0, PEAK_FLOPS["float32"],
                   select_bytes(rows, c, k, with_ids))


def segmented_plan(n: int, q: int, k: int, n_segments: int = 8,
                   query_chunk: int = 1024) -> Tuple[int, int, int]:
    """(seg_k, segment length, query chunks) of the segment merge over an
    (n, d) corpus: the top seg_k of each of ``n_segments`` blocks (~1.5x the
    even split, never fewer merged candidates than k), the corpus padded
    to a multiple of the segments, the queries to one of the chunk."""
    seg_k = max(k // n_segments + k // (2 * n_segments), 1,
                -(-k // n_segments))
    seg_k = max(seg_k, -(-k // n_segments))
    seg_len = -(-n // n_segments)
    return seg_k, seg_len, -(-q // query_chunk)


def segmented_select_bytes(n: int, q: int, k: int, n_segments: int = 8,
                           query_chunk: int = 1024) -> int:
    """B5's bytes in one segment merge: per query chunk the per-segment
    selection over (chunk · segments, segment length) scores, then the
    merge of the chunk's (chunk, segments · seg_k) candidates with ids."""
    seg_k, seg_len, chunks = segmented_plan(n, q, k, n_segments,
                                            query_chunk)
    per_chunk = select_bytes(query_chunk * n_segments, seg_len, seg_k,
                             False) \
        + select_bytes(query_chunk, n_segments * seg_k, k, True)
    return chunks * per_chunk


def b1_bytes(n_ids: int, unique: int, dims: Sequence[int],
             grad_itemsize: int) -> int:
    """B1, the row-wise AdaGrad update of a pack: per gathered row its
    int32 id and its slots' accumulators read, each slot's gradient read;
    per distinct row the used columns (values and one accumulator a slot)
    read and written once."""
    used = sum(dims) + len(dims)
    return n_ids * (4 + 4 * len(dims)) + n_ids * sum(dims) * grad_itemsize \
        + unique * used * 4 * 2


def b1_bound_s(n_ids: int, unique: int, dims: Sequence[int],
               grad_itemsize: int) -> Tuple[float, str]:
    """B1's bound: its bytes against ~6 f32 operations an element."""
    return bound_s(6.0 * n_ids * sum(dims), PEAK_FLOPS["float32"],
                   b1_bytes(n_ids, unique, dims, grad_itemsize))


def mlp_flops(in_dim: int, widths: Sequence[int]) -> int:
    """Forward operations of a stack of dense layers: 2 · in · out each."""
    total = 0
    for w in widths:
        total += 2 * in_dim * w
        in_dim = w
    return total


def two_tower_user_flops(embedding_dim: int, hidden: Sequence[int]) -> int:
    """YoutubeDNN's user tower a user: the MLP over the user-id embedding
    and the pooled history, [2·D] → hidden → D (the last width is D)."""
    return mlp_flops(2 * embedding_dim, list(hidden))


def serve_flops_per_user(n_items: int, embedding_dim: int,
                         hidden: Sequence[int]) -> int:
    """A served user: the user tower and its dot product with every item
    (2 · N · D)."""
    return two_tower_user_flops(embedding_dim, hidden) \
        + 2 * n_items * embedding_dim


def deepfm_flops_per_example(n_fields: int, embedding_dim: int,
                             hidden: Sequence[int]) -> int:
    """DeepFM's dense layers a trained example: the forward over the
    (F · D)-wide field embeddings through ``hidden`` to one logit, and the
    backward at twice that (the inputs' gradient, which the embedding rows
    need, and the weights')."""
    return 3 * mlp_flops(n_fields * embedding_dim, list(hidden) + [1])
