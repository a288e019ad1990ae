"""PyTorch + CUDA port of `reflectionflow_tpu` for NVIDIA Hopper GPUs.

Same module layout and function names as the JAX package, which stays the
reference. Imports torch and numpy only; see README "PyTorch port (H100)".
"""
