"""The port's benchmark: one cell of ``BENCHMARK.json`` run once by
``run.py``. Configurations, traffic mixes, cells and per-layer metrics are
files found by name (``core/spec.py``)."""
