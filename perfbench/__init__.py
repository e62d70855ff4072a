"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

One command runs one cell (a configuration under a traffic mix, as named
in ``BENCHMARK.json`` at the root of the checkout)::

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, mix, per-layer metric or
reference family is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``reference/<family>.py`` and
``limits/<workload>.json``.  The yardstick (peaks, operation and byte
counts) is :mod:`perfbench.yardstick`; the comparison that decides
``correct`` is :mod:`perfbench.check`.
"""
