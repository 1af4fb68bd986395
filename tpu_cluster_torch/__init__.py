"""PyTorch/CUDA port of the stack, for NVIDIA Hopper: its accelerator side,
and of its control plane the cluster spec, the renderers, the bundle
linter, the apply engine, the Events pipeline, the acceptance and triage
runbooks and the Helm chart (``python -m tpu_cluster_torch
render|lint|apply|delete|events|verify|triage``).

``tpu_cluster`` (JAX) stays the reference; this package imports torch,
never jax, and nothing of ``tpu_cluster``: it keeps its own copy of what
it needs. Entry points run on ``torch.device("cuda")`` unless the caller
passes another device (the tests pass the CPU).
"""
