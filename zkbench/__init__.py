"""zkbench: the benchmark of the PyTorch/CUDA port, ``zkstream_tpu_torch``.

One command runs one cell once, on the machine it is started on::

    python3 -m zkbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

and prints one JSON line last.  ``BENCHMARK.json`` at the repository
root names the cells; ``spec.py`` finds each one's files by name.
Nothing here imports JAX or the JAX package, and the plain reference
(``reference/``) imports nothing of the port.
"""
