"""The H100 benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and prints
one JSON line.  Everything that belongs to one configuration, traffic mix
or metric is a file found by its name:

* ``configs/<config>.json``: the deployment (rows, columns, index spec);
* ``traffic/<mix>.json``: the parameters of one mix, read by
  :mod:`h100_bench.workload`;
* ``metrics/<metric>.py``: one reader a metric, ``read(run) -> float | None``.

The yardstick lives here too: the frozen table generators (``data/``),
the plain NumPy reference (``reference/``), the roofline arithmetic
(:mod:`h100_bench.roofline`) and the trace reduction
(:mod:`h100_bench.trace`).  Nothing here imports JAX or the JAX package.
"""
