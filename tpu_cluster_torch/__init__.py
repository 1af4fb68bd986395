"""PyTorch/CUDA port of the stack's accelerator side, for NVIDIA Hopper.

``tpu_cluster`` (JAX) stays the reference; this package imports torch,
never jax, and nothing of ``tpu_cluster``: it keeps its own copy of what
it needs. Entry points run on ``torch.device("cuda")`` unless the caller
passes another device (the tests pass the CPU).
"""
