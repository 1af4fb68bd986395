"""The port's workloads: the burn-in transformer and the serving engine."""
