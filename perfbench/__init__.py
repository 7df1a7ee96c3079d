"""The port's benchmark: one cell a run, driven by ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
