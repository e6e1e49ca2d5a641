"""portbench: the benchmark of the PyTorch and CUDA port (``hydragen_torch``).

One command runs one cell (a model configuration under a traffic mix) once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json`` (which names its driver,
``drivers/<kind>.py``), ``metrics/<metric>.py`` and ``limits/<cell>.json``.
Nothing here imports JAX or the JAX package.
"""
