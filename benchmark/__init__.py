"""The benchmark of fithubert_tpu_torch (the PyTorch / CUDA port) on one
H100: ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, the cells listed in ``BENCHMARK.json``."""
