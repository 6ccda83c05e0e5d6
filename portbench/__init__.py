"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command, ``python3 portbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``, driven by ``BENCHMARK.json`` at the checkout's root."""
