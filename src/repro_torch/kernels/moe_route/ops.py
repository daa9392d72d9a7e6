"""The router as the model calls it (``models.layers.moe_dense``): the
CUDA kernel on a CUDA tensor, the plain version on a CPU tensor, an
error on any other device."""
from __future__ import annotations

from repro_torch.kernels.moe_route import kernel as K
from repro_torch.kernels.moe_route import ref as R


def route_dense(logits, k: int, renormalize: bool, dtype):
    """logits (T, E) -> (weights (T, k) float32, idx (T, k) int32, dense
    combine weights (T, E) of ``dtype``), in one launch on CUDA."""
    dev = logits.device
    if dev.type == "cuda":
        return K.route_cuda(logits.contiguous(), k, renormalize, dtype)
    if dev.type == "cpu":
        return R.route_dense_ref(logits, k, renormalize, dtype)
    raise ValueError(f"no router for device {dev}")
