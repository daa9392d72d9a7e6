"""Batch market engine on PyTorch tensors (twin of ``repro.market_jax``)."""
