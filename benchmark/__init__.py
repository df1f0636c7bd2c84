"""The benchmark of ``jincresize_tpu_torch`` (see ``README.md``).

Run one cell with ``python benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout on a machine with
a CUDA card. Cells, metrics and bounds are in the root ``BENCHMARK.json``;
what belongs to one configuration, traffic mix or metric is a file of its
own under ``configs/``, ``traffic/`` or ``metrics/``, found by its name.
Nothing here imports JAX or the JAX package, and ``reference/`` imports
nothing of the port either.
"""
