"""The benchmark of ``repro_torch``: one cell, one run (``bench/run.py``).

Everything that belongs to one configuration, traffic mix, per-layer metric,
kind of work or kind of check is a file of its own, which the harness finds
by the name that ``BENCHMARK.json`` gives (``bench/README.md``).  Nothing
here imports ``jax`` or the JAX package ``repro``; only
``bench/entries/`` imports the program.
"""
