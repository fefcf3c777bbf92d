"""Collective inspection: PROVE the sharded comm pattern.

Own copy of `recbox_tpu/parallel/inspect.py` (:1-144). `CollectiveOp`,
`_shape_bytes`, `parse_collectives` and `collective_summary` are JAX's as
they are (plain `re`; `parse_collectives` still reads XLA's HLO text, so a
test can hold the port's count to JAX's compiled step).

The centerpiece of the parallel design is row-sharded embedding tables
whose per-step exchange must be id/row-shaped — bytes proportional to the
BATCH, never to the VOCAB (a full-table all-gather would be silently
catastrophic at production table sizes).

`collective_stats(fn, *args, **kwargs)` has no HLO to parse here: PyTorch
issues each collective eagerly. It runs ``fn`` ONCE under the recorder of
`parallel.mesh` and returns one `CollectiveOp` per collective the port
issued, with JAX's kind names (``all-gather``, ``all-reduce``, ...) and the
bytes of its result as JAX counts them (the gathered or reduced buffer on
this rank). Every collective of the port goes through the wrappers of
`parallel.mesh`, so the recorder sees all of them. Unlike JAX's, which
only compiles, the call advances the function's state (a train step
steps).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Sequence

__all__ = ["CollectiveOp", "collective_stats", "collective_summary",
           "parse_collectives"]

# HLO primitive byte widths (sizes of the element types that can appear in
# our programs; extend as needed)
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

# op names that move data across mesh participants (plus async -start
# variants; -done carries no new bytes). `collective-permute` covers the
# halo/permute family; `all-to-all` is the id-exchange shape.
_COLLECTIVE_RE = re.compile(
    r"\b(all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(")

# one typed buffer inside an HLO shape, e.g. f32[2048,16]
_BUFFER_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


@dataclasses.dataclass
class CollectiveOp:
    kind: str          # all-gather | all-reduce | ...
    result_shape: str  # the full HLO result type text
    bytes: int         # total bytes of the op's result buffers
    line: str          # the HLO line (trimmed) for debugging


def _shape_bytes(type_text: str) -> int:
    """Total bytes across every typed buffer in an HLO type string.

    Handles tuples like ``(f32[8,16], f32[8,16])`` by summing members.
    Token/opaque types contribute 0.
    """
    total = 0
    for dtype, dims in _BUFFER_RE.findall(type_text):
        if dtype not in _DTYPE_BYTES:
            continue  # token, opaque, sparse metadata
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def parse_collectives(hlo_text: str) -> List[CollectiveOp]:
    """Extract communication ops (with byte sizes) from optimized HLO text."""
    out: List[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_RE.search(line)
        if not m:
            continue
        # result type is everything between '=' and the op name
        head = line[: m.start()]
        eq = head.find("=")
        result_type = head[eq + 1:].strip() if eq >= 0 else ""
        # async '-start' ops have tuple type (operand, ..., result): the
        # operand member is aliased, not transferred — counting the whole
        # tuple would inflate comm bytes up to ~2x whenever XLA
        # async-ifies a collective. Keep only the LAST tuple member (the
        # result, matching what the sync form of the same op reports).
        if m.group(0).endswith("-start(") and result_type.startswith("("):
            inner = result_type.strip("()")
            depth, parts, cur = 0, [], ""
            for ch in inner:
                if ch == "," and depth == 0:
                    parts.append(cur)
                    cur = ""
                    continue
                if ch in "({[":
                    depth += 1
                elif ch in ")}]":
                    depth -= 1
                cur += ch
            parts.append(cur)
            # the RESULT is the last ARRAY member; async ops can carry
            # trailing u32[]/s32[] context scratch fields whose 0-4 bytes
            # would undercount the op to ~nothing
            array_parts = [p_ for p_ in parts
                           if re.match(r"\s*(f|bf|s|u)\d+\[[^\]]+\]",
                                       p_.strip())]
            result_type = (array_parts[-1] if array_parts
                           else parts[-1]).strip()
        out.append(CollectiveOp(
            kind=m.group(1),
            result_shape=result_type,
            bytes=_shape_bytes(result_type),
            line=line.strip()[:200],
        ))
    return out


def collective_stats(fn: Callable, *args, **kwargs) -> List[CollectiveOp]:
    """Run ``fn(*args, **kwargs)`` once and return the collectives it
    issued on this rank, in order (none on a world of one)."""
    from recbox_tpu_torch.parallel.mesh import record_collectives
    with record_collectives() as ops:
        fn(*args, **kwargs)
    return list(ops)


def collective_summary(ops: Sequence[CollectiveOp]) -> Dict[str, Dict[str, int]]:
    """{kind: {count, bytes}} rollup of `collective_stats` output."""
    out: Dict[str, Dict[str, int]] = {}
    for op in ops:
        d = out.setdefault(op.kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += op.bytes
    return out
