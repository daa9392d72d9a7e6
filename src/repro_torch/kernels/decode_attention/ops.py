"""Decode attention as the model calls it: the CUDA kernel on CUDA
tensors, the plain version on CPU tensors, an error on any other
device.  ``pos`` is a host integer (a tensor costs one device read)."""
from __future__ import annotations

from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref as R


def decode_attention(q, k, v, pos, window: int = 0):
    """q (B, K, G, hd); k/v (B, S, K, hd) -> (B, K, G, hd)."""
    pos = int(pos)
    dev = q.device
    if dev.type == "cuda":
        return K.decode_attention_cuda(q.contiguous(), k, v, pos, window)
    if dev.type == "cpu":
        return R.decode_attention_ref(q, k, v, pos, window)
    raise ValueError(f"no decode attention for device {dev}")
