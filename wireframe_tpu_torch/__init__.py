"""PyTorch/CUDA port of wireframe_tpu for one NVIDIA H100.

A second package beside the JAX reference `wireframe_tpu/`, with the same
module layout and names.  It imports torch and numpy, never jax, flax or
the JAX package.  It trains, evaluates and serves the shipped recipe
(`configs/recommended.yaml`) and the reference-parity model
(`configs/default.yaml`) from a Building3D corpus (`main.py`,
`evaluate.py`, `test.py`, `serve.py`), with the JAX package's five
Pallas kernels as hand-written CUDA kernels for Hopper (`csrc/`).
"""
