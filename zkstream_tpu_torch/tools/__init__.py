"""The port's measuring tools, copies of the JAX package's ``tools/``:
``sweep_crossover``, ``diag_ingest``, ``crossover_encode``,
``profile_hotpath``, ``bench_linearize``, ``asan_check`` and ``cover``
(each ``python -m zkstream_tpu_torch.tools.<name>``), and the helper
program the port's bench spawns (``read_worker``)."""
