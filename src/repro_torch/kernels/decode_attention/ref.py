"""Plain PyTorch version of flash-decode attention, twin of
``repro.kernels.decode_attention.ref.decode_attention_ref``, and its
partial form over one block of the cache with the merge of the blocks'
partials (the cross-rank route of a cache whose sequence is cut)."""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30     # the reference's mask value, not -inf: a fully
                         # masked row gives the same uniform softmax


def _valid(S: int, pos: int, window: int, offset: int,
           device) -> torch.Tensor:
    t = torch.arange(S, device=device) + offset
    valid = t <= pos
    if window:
        valid &= t > pos - window
    return valid


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: int, window: int = 0) -> torch.Tensor:
    """q (B, K, G, hd); k/v (B, S, K, hd); attend to cache positions
    t <= pos (and t > pos - window if window).  Returns (B, K, G, hd) in
    q's dtype; accumulation in float32."""
    B, S, K, hd = k.shape
    scale = hd ** -0.5
    scores = torch.einsum("bkgh,btkh->bkgt", q.float(), k.float()) * scale
    valid = _valid(S, pos, window, 0, k.device)
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    return out.to(q.dtype)


def decode_attention_partial_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, pos: int, window: int = 0,
                                 offset: int = 0):
    """The softmax of q against one block of the cache, k/v (B, S_block,
    K, hd), whose position ``t`` is the global position ``offset + t``,
    masked as ``decode_attention_ref`` masks the whole cache.  Returns
    float32 ``(o, m, l)``: ``o`` (B, K, G, hd) the block's
    softmax-weighted values, ``m`` (B, K, G) the row max of its scaled
    scores and ``l`` (B, K, G) the sum of ``exp(score - m)``.  A block
    with no valid position has every score ``NEG_INF``, so ``m`` is
    ``NEG_INF``, ``l`` is ``S_block`` and ``o`` the mean of its values."""
    B, S, K, hd = k.shape
    scale = hd ** -0.5
    scores = torch.einsum("bkgh,btkh->bkgt", q.float(), k.float()) * scale
    valid = _valid(S, pos, window, offset, k.device)
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", p, v.float()) / l[..., None]
    return o, m, l


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The whole cache's attention from its R blocks' partials, stacked
    on a leading rank dim: o (R, B, K, G, hd), m and l (R, B, K, G), all
    float32.  ``M = max_r m_r``, ``w_r = l_r exp(m_r - M)``, ``out = sum_r
    w_r o_r / sum_r w_r``, cast to ``dtype`` once at the end.  Where any
    position is valid a fully masked block weighs 0 (``exp(-2**30 -
    M)``); where none is, every ``m_r`` is ``NEG_INF`` and the result is
    the reference's uniform softmax over all positions."""
    M = m.amax(dim=0)
    w = l * torch.exp(m - M)
    out = (w[..., None] * o).sum(dim=0) / w.sum(dim=0)[..., None]
    return out.to(dtype)
