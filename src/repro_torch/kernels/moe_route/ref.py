"""Plain PyTorch version of the MoE router, twin of
``repro.kernels.moe_route.ref.route_ref``.

The reference takes the top k with ``lax.top_k``, which puts the lowest
index first among equal values; ``torch.topk`` promises no order among
ties, so the plain version does what the Pallas kernel does: k rounds of
max, the lowest index holding the maximum, then mask it.
"""
from __future__ import annotations

import torch


def route_ref(logits: torch.Tensor, k: int, renormalize: bool = True):
    """logits (T, E) -> (weights (T, k) float32, idx (T, k) int32)."""
    T, E = logits.shape
    if not 1 <= k <= E:
        raise ValueError(f"k={k} outside [1, E={E}]")
    p = torch.softmax(logits.float(), dim=-1)
    lane = torch.arange(E, device=logits.device)
    ws, ids = [], []
    for _ in range(k):
        w = p.max(dim=-1).values                            # (T,)
        idx = torch.where(p >= w[:, None], lane, E).min(dim=-1).values
        p = torch.where(lane == idx[:, None], -1.0, p)      # probs >= 0
        ws.append(w)
        ids.append(idx)
    w = torch.stack(ws, dim=-1)
    if renormalize:
        w = w / w.sum(dim=-1, keepdim=True)
    return w, torch.stack(ids, dim=-1).to(torch.int32)


def route_dense_ref(logits: torch.Tensor, k: int, renormalize: bool,
                    dtype: torch.dtype):
    """``route_ref``, then the dense combine weights as the reference's
    ``moe_dense`` builds them (``zeros`` -> ``scatter_`` -> ``.to``):
    -> (weights (T, k) float32, idx (T, k) int32, dense (T, E) dtype)."""
    w, idx = route_ref(logits, k, renormalize)
    dense = torch.zeros(logits.shape, dtype=torch.float32,
                        device=logits.device)
    dense.scatter_(1, idx.long(), w)
    return w, idx, dense.to(dtype)
