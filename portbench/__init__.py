"""The benchmark of ``gaplac_tpu_torch`` on the card: ``python3 -m
portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``
(``run.py``); the cells, metrics and bounds are in ``BENCHMARK.json`` at the
root of the repository."""
