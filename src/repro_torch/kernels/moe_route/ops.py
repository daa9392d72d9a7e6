"""The router as the model calls it: the CUDA kernel on a CUDA tensor,
the plain version on a CPU tensor, an error on any other device."""
from __future__ import annotations

from repro_torch.kernels.moe_route import kernel as K
from repro_torch.kernels.moe_route import ref as R


def route(logits, k: int, renormalize: bool = True):
    """logits (T, E) -> (weights (T, k) float32, idx (T, k) int32)."""
    dev = logits.device
    if dev.type == "cuda":
        return K.route_cuda(logits.contiguous(), k, renormalize)
    if dev.type == "cpu":
        return R.route_ref(logits, k, renormalize)
    raise ValueError(f"no router for device {dev}")
