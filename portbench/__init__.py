"""The benchmark of ``muninn_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything that belongs to one configuration, traffic mix, engine,
metric, kernel count or control is a file of its own under this folder,
found by the name ``BENCHMARK.json`` or a traffic file gives it
(``README.md``). Nothing here imports ``jax`` or ``muninn_tpu``; the
reference (``reference.py``) and the controls import nothing of
``muninn_tpu_torch`` either.
"""
