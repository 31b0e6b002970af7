"""Hand-written CUDA kernels of the port, their plain PyTorch versions and the
plane-major site tables they read."""
