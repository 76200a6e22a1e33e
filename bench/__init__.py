"""The benchmark of the port ``repro_torch`` on one NVIDIA H100: cells,
traffic, the plain reference and the readers of every metric.  Run a cell
with ``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout."""
