"""The benchmark of the PyTorch and CUDA port (``tpu_cluster_torch``) on
one NVIDIA H100: ``python3 -m portbench.run --workload <cell> ...``."""
