"""PyTorch/CUDA port of creamfl_tpu for NVIDIA Hopper (H100).

Imports neither JAX nor the JAX package; see README "PyTorch/CUDA port".
"""
