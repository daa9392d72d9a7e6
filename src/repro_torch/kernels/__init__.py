"""Kernels of the port: a plain PyTorch version and a hand-written CUDA
kernel for each, built from ``csrc/`` on first use."""
