"""Flash-decode attention of one query token against a KV cache (plain
version, CUDA kernel, ops)."""
