"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on one NVIDIA H100.

`python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json`.  Imports the program, torch, numpy and the
standard library; never JAX or the JAX package.
"""
