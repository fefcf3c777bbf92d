"""The benchmark of `recbox_tpu_torch`, the PyTorch and CUDA port.

One command runs one cell once (``python3 -m benchmark.run --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``). `BENCHMARK.json` at the
repository root names the cells, the metrics and the configurations; each
of those is a file of its own under this folder, found by its name:

- ``configs/<config>.json``: a configuration's sizes, the system module
  that drives it and the plain reference beside it;
- ``traffic/<traffic>.json``: a traffic mix's parameters, read by the
  general generators of `traffic.py`;
- ``limits/<cell>.json``: the limits of the numbers that decide a cell's
  ``correct``, with the readings each was set from;
- ``metrics/<metric>.py``: a per-layer metric's reader, unit and the
  end-to-end metric it moves;
- ``systems/<system>.py``: set-up, the timed window and the comparison of
  one kind of system under test;
- ``reference/<model>.py``: the plain PyTorch reference of a model.

Nothing here imports JAX or the JAX package, and nothing under
``reference/`` imports the port.
"""
