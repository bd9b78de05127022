"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on the H100.

``python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; ``bench/harness.py`` says how the
cell's pieces are found.  Nothing here imports JAX or the JAX package.
"""
