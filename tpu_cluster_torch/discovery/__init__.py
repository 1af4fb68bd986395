"""Card discovery and node labels: the counterpart of
``tpu_cluster/discovery`` for NVIDIA cards."""
