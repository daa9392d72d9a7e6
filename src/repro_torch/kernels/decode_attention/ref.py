"""Plain PyTorch version of flash-decode attention, twin of
``repro.kernels.decode_attention.ref.decode_attention_ref``."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30     # the reference's mask value, not -inf: a fully
                         # masked row gives the same uniform softmax


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: int, window: int = 0) -> torch.Tensor:
    """q (B, K, G, hd); k/v (B, S, K, hd); attend to cache positions
    t <= pos (and t > pos - window if window).  Returns (B, K, G, hd) in
    q's dtype; accumulation in float32."""
    B, S, K, hd = k.shape
    scale = hd ** -0.5
    scores = torch.einsum("bkgh,btkh->bkgt", q.float(), k.float()) * scale
    t = torch.arange(S, device=k.device)
    valid = t <= pos
    if window:
        valid &= t > pos - window
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    return out.to(q.dtype)
