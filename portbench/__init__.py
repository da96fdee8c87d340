"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Every
configuration, traffic mix, per-cell limit and metric is a file of its own
under this folder, found by the name ``BENCHMARK.json`` gives it (see
``README.md``).
"""
