"""The router as the model calls it (``models.layers.moe_dense``): the
CUDA kernel on a CUDA tensor, the plain version on a CPU tensor (and on
a ``meta`` one, where it gives the shapes and dtypes: the dry run
traces there), an error on any other device; with a gradient on
either.

The kernel's outputs carry no ``grad_fn``, so ``route_dense`` is an
``autograd.Function``.  Its backward is the closed form of the
reference's ``softmax -> top_k -> renormalize -> scatter`` (what XLA's
autodiff of ``_router_topk`` computes; the TPU kernel has no backward).
It recomputes ``p = softmax(logits)`` from the saved logits and follows
the forward's own ``idx``, where the lowest index wins ties, as in
``lax.top_k``; it never reruns the plain version's rounds of max.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_route import kernel as K
from repro_torch.kernels.moe_route import ref as R


def _route(logits, k: int, renormalize: bool, dtype):
    dev = logits.device
    if dev.type == "cuda":
        return K.route_cuda(logits.contiguous(), k, renormalize, dtype)
    if dev.type in ("cpu", "meta"):
        return R.route_dense_ref(logits, k, renormalize, dtype)
    raise ValueError(f"no router for device {dev}")


def route_backward(logits, idx, g_w, g_dense, renormalize: bool):
    """d loss / d logits from the upstream gradients of the weights
    (T, k) and of the dense combine weights (T, E); either may be None.

    With ``g_r`` the gradient reaching top-k slot r (its weight's, plus
    the dense weights' at ``idx[:, r]``): renormalised, ``w_r = p_{i_r} /
    S`` with ``S`` the sum of the k probabilities, so ``dp_{i_r} = (g_r
    - sum_s g_s w_s) / S``; otherwise ``dp_{i_r} = g_r``.  Every other
    ``dp`` is 0, and ``dlogits = p * (dp - sum_e p_e dp_e)``."""
    p = torch.softmax(logits.float(), dim=-1)
    ids = idx.long()
    g = torch.zeros(ids.shape, dtype=torch.float32, device=logits.device)
    if g_dense is not None:
        g = g + torch.gather(g_dense.float(), 1, ids)
    if g_w is not None:
        g = g + g_w.float()
    if renormalize:
        s = torch.gather(p, 1, ids).sum(dim=-1, keepdim=True)
        w = torch.gather(p, 1, ids) / s
        g = (g - (g * w).sum(dim=-1, keepdim=True)) / s
    dp = torch.zeros_like(p).scatter_(1, ids, g)
    dlogits = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    return dlogits.to(logits.dtype)


class _RouteDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, k, renormalize, dtype):
        w, idx, dense = _route(logits, k, renormalize, dtype)
        ctx.save_for_backward(logits, idx)
        ctx.renormalize = renormalize
        ctx.mark_non_differentiable(idx)
        ctx.set_materialize_grads(False)
        return w, idx, dense

    @staticmethod
    def backward(ctx, g_w, _g_idx, g_dense):
        logits, idx = ctx.saved_tensors
        return (route_backward(logits, idx, g_w, g_dense, ctx.renormalize),
                None, None, None)


def route_dense(logits, k: int, renormalize: bool, dtype):
    """logits (T, E) -> (weights (T, k) float32, idx (T, k) int32, dense
    combine weights (T, E) of ``dtype``), in one launch on CUDA;
    differentiable in the logits through the weights and the dense
    weights."""
    return _RouteDense.apply(logits, k, renormalize, dtype)
