"""The benchmark of the PyTorch port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything that belongs to one configuration, traffic mix, metric or check
sits in a file of its own that the harness finds by the name
``BENCHMARK.json`` gives it (see :mod:`bench.spec`).
"""
