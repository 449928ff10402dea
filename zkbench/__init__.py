"""The benchmark of `latticeum_tpu_torch`, the PyTorch/CUDA port: one run
of one cell is `python3 zkbench/run.py --workload <cell> ...` (README.md).
It imports neither jax nor the JAX package `latticeum_tpu`."""
