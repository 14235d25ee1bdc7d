"""PyTorch/CUDA port of wireframe_tpu for one NVIDIA H100.

A second package beside the JAX reference `wireframe_tpu/`, with the same
module layout and names.  It imports torch and numpy, never jax, flax or
the JAX package.  This slice serves the shipped recipe
(`configs/recommended.yaml`) end to end; the encoder's fused kernel K1 is
a hand-written CUDA kernel (`csrc/fused_encoder.cu`).
"""
