"""The port's benchmark: ``python3 bench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` (see README.md)."""
