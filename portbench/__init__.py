"""The benchmark of `veneur_tpu_torch`, the PyTorch/CUDA port of veneur.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line. Everything a cell needs is found by name: its configuration in
`configs/`, its traffic mix in `traffic/`, its limits in `workloads/`,
and each metric's reader in `metrics/`.
"""
