"""The benchmark of the PyTorch/CUDA port (``poly_commit_tpu_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one CUDA card
and prints one JSON line. Everything a cell names is found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``schemes/<scheme>.py``,
``metrics/<metric>.py`` and ``reference/<scheme>.py``, so a configuration,
a traffic mix or a metric is added by adding files. Nothing here imports
JAX or the JAX package; the reference imports nothing of the port.
"""
