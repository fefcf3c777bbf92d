"""The JAX package's 14 example scripts (`examples/`), written against the
port: one module each, under the script's file name.

Each keeps its script's data, seeds, sizes, configuration and final
``assert``, imports the port through public names only (names in a
module's ``__all__``), and has a ``main(device=None)`` that prints what the
script prints and returns it. ``device=None`` is the CUDA device, as for
every entry point of the port::

    python -m recbox_tpu_torch.examples.<name> [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

__all__ = ["EXAMPLES", "run_cli"]

EXAMPLES = ("big_vocab_packed", "cascade_three_stage",
            "eval_protocols_and_acquire", "hyper_tuning", "knowledge_cke",
            "large_vocab_flash_ce", "matching_two_tower", "multitask_mmoe",
            "one_call_run_experiment", "ranking_deepfm", "rerank_prm",
            "sequential_sasrec", "serving_retrieval", "streaming_shards")


def run_cli(main: Callable, argv: Optional[Sequence[str]] = None) -> None:
    """An example's command line: ``--device`` (the card by default)."""
    parser = argparse.ArgumentParser(description=main.__module__)
    parser.add_argument("--device", default=None,
                        help="'cpu', 'cuda' or 'cuda:N' (default: cuda)")
    main(device=parser.parse_args(argv).device)
