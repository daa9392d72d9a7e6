"""PyTorch port of the LaissezCloud batch market and vectorized fleet.

``repro_torch`` mirrors ``repro`` (``market_jax/`` is ``market_torch/``)
and holds the same state contract, so the JAX package stays the
reference every module is checked against.  Entry points take
``device=None``, which means CUDA; they raise when CUDA is missing and
run on the CPU only when the caller passes ``device="cpu"``.  The
market-clearing pass runs as a hand-written CUDA kernel on CUDA
tensors and as its plain PyTorch version on CPU tensors.
"""
