"""chaosbench: the benchmark of the PyTorch and CUDA port ``repro_torch``.

``python3 chaosbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Configurations, traffic mixes, metrics and limits are files of this
folder found by the names in ``BENCHMARK.json`` (``catalog``); nothing here
imports JAX or the JAX package.
"""
