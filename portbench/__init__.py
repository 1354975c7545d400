"""The benchmark of ``vietnamese_qa_system_tpu_torch`` on one NVIDIA H100.

One command runs one cell once (``python3 portbench/run.py --workload W
--seed N --seconds S --trace 0|1``).  Everything that belongs to one
configuration, traffic mix, driver or per-layer metric lives in a file of
its own under this folder, found by the name that ``BENCHMARK.json`` gives
it; ``README.md`` says how to add one.  Nothing here imports ``jax`` or the
JAX package, and nothing under ``reference/`` imports the port.
"""
