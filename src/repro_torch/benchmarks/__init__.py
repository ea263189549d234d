"""The port's benchmark suite: one module per paper table or figure, and
the kernel microbenchmarks, run as ``python -m repro_torch.benchmarks.run``.

The port of the repository's ``benchmarks/`` package, on the port's
simulator, plan API and backends."""
