"""The plain reference that decides ``correct``: plain PyTorch, float32,
no kernel, cache or batching, and nothing of the program."""
