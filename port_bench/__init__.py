"""The benchmark of the PyTorch and CUDA port (`wireframe_tpu_torch`).

Run one cell from the root of a checkout:

    python -m port_bench --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` at the root names the cells, configurations and
metrics; this package holds the yardstick (traffic generation, operation
counts, peaks, trace reduction, the plain reference and the comparison
that decides `correct`).  It imports neither JAX nor the JAX package.
"""
