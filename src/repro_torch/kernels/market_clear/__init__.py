"""Hierarchical market-clearing pass (plain version, CUDA kernel, ops)."""
