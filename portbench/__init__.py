"""The benchmark of the PyTorch and CUDA port (`yams_tpu_torch`).

`python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once (see `run.py`). Nothing here imports
JAX, the JAX package or the root bench.py; the reference
(`reference/`) imports nothing of the port either.
"""
