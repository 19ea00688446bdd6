"""splatbench: the benchmark of `gsplat_tpu_torch` on an NVIDIA card.

`python3 splatbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json`; `splatbench/README.md`
says how cells, configurations, traffic and metrics are found by name.
"""
