"""Device kernels of the port: hand-written CUDA under ``csrc/``, each with
its wrapper and plain PyTorch version beside it."""
