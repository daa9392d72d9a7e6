"""Fused MoE router: softmax over the experts, then top-k (plain version,
CUDA kernel, ops)."""
