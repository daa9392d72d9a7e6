"""Mamba2 SSD chunked scan (plain version, CUDA kernel, ops)."""
