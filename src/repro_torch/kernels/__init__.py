"""Hand-written GPU kernels of the port, each with its plain PyTorch
version beside it (``csrc/`` holds the CUDA sources)."""
