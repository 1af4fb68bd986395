"""Kubernetes objects the port renders: the validation Jobs."""
