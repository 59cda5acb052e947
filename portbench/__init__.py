"""portbench: the benchmark of the PyTorch/CUDA port (tpufem_torch).

One run of one cell: ``python3 -m portbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` (see run.py).  The cells, metrics and
bounds are in BENCHMARK.json at the root of the repository; each cell's
configuration, traffic mix, path and metrics are files of their own here
(spec.py says how they are found).  Nothing here imports the JAX package
or JAX; the reference (reference/) imports nothing of the program.
"""
