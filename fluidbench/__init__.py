"""The benchmark of ``cudafluidsimulation_tpu_torch``: one cell a run
(``python3 -m fluidbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``), its cells, metrics and bounds in ``BENCHMARK.json``."""
