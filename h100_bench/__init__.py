"""The H100 benchmark of ``ase_tpu_torch``, the PyTorch / CUDA port.

One command runs one cell of ``BENCHMARK.json`` once:

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one cell's limits is a file of its own, found by name:
``configs/<config>.yaml``, ``traffic/<traffic>.yaml``,
``metrics/<metric>.py`` and ``limits/<cell>.yaml``. ``reference/`` holds the
plain reference that decides ``correct`` (a frozen copy of the port's
plain code paths); ``tracing/`` the trace reader and the spans the harness
wraps around calls into the program's layers in traced runs.

Nothing here imports ``jax`` or the JAX package ``ase_tpu``; the reference
imports nothing of ``ase_tpu_torch`` either.
"""
