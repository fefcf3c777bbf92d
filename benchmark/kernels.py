"""Which device activities of a trace belong to which kernel or layer, by
name (CUPTI's demangled kernel names and memcpy rows), lower-cased."""


def b3(name: str) -> bool:
    """Kernel B3: stage (a), B4's candidate kernels (every route), and
    stage (b), the selection with B3's epilogue (``WinnerOut``)."""
    n = name.lower()
    return "segment_candidates" in n or ("select" in n and "winnerout" in n)


def b5(name: str) -> bool:
    """Kernel B5: the selection with B5's epilogue (``RowOut``)."""
    n = name.lower()
    return "select" in n and "rowout" in n


def b1(name: str) -> bool:
    """Kernel B1, the packed row-wise AdaGrad update."""
    return "packed_adagrad_update" in name.lower()


def to_host(name: str) -> bool:
    """A copy from the device to the host."""
    return "memcpy dtoh" in name.lower()


def packed_path(name: str) -> bool:
    """The packed trainer's own work: B1, the gather of the pack rows
    (``index_select`` / gather kernels) and the copies (the rows handed to
    the model, the stacked batches staged for a call)."""
    n = name.lower().replace("_", "")
    return b1(name) or any(s in n for s in ("indexselect", "gather", "copy"))
