"""The benchmark of ``horovod_tpu_torch`` on NVIDIA GPUs.

``python3 port_bench/run.py --workload NAME --seed N --seconds S --trace
0|1`` runs one cell of ``BENCHMARK.json`` and prints one JSON line. The
cells, configurations, traffic mixes and per-layer metrics live in files of
their own under this directory and are found by name (``registry.py``).
Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the port either.
"""
