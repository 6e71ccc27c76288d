"""wqlbench: the benchmark of the PyTorch/CUDA port of the WorldQL broker.

``python -m wqlbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (see README.md).
Configurations, traffic mixes and metrics are files found by name, so a
new cell is added with files, not by editing the harness.
"""
