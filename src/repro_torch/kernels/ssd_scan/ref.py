"""Plain PyTorch version of the Mamba2 SSD chunked scan, twin of
``repro.models.layers.ssd_chunked`` (which the reference's
``kernels.ssd_scan.ref.ssd_scan_ref`` calls) without ``init_state``, an
argument no caller passes.

The reference carries the state between chunks with
``lax.associative_scan``; this version walks the chunks in order, as the
Pallas kernel does, so the float32 sums run in another order (within
the reference's own kernel tolerances, 3e-4 in float32 and 4e-2 in
bfloat16).  Everything else keeps the reference's arithmetic: the
intra-chunk Gram matrix ``C Bᵀ`` is taken in the inputs' dtype (rounded
to bfloat16 for bfloat16 inputs, as XLA does) and every other product in
float32; y is cast to x's dtype once, at the end.  A length that is not a
multiple of ``chunk`` is padded with ``dt = 0``: no decay and no input,
so the final state and the real positions' outputs are exact.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """x: (B,S,H,P); dt: (B,S,H) float32; A: (H,) float32, negative;
    Bm/Cm: (B,S,N).  Returns (y (B,S,H,P) in x's dtype, final_state
    (B,H,P,N) float32)."""
    b, s, h, pd = x.shape
    n = Bm.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xr = x.reshape(b, nc, chunk, h, pd)
    dtr = dt.reshape(b, nc, chunk, h)
    Br = Bm.reshape(b, nc, chunk, n)
    Cr = Cm.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtr * A, dim=2)                   # inclusive, <= 0
    # intra-chunk: exp(cum_i - cum_j) for j <= i, 0 above the diagonal
    # (masked before the exp, so no inf is ever formed)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    gap = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,nc,i,j,h)
    decay = torch.exp(torch.where(mask[None, None, :, :, None], gap,
                                  float("-inf")))
    G = torch.einsum("bcin,bcjn->bcij", Cr, Br).float()
    xdt = xr * dtr[..., None]                            # float32
    y = torch.einsum("bcijh,bcjhp->bcihp", G[..., None] * decay, xdt)
    # each chunk's own contribution to the state, then the carry
    to_end = torch.exp(cum[:, :, -1:, :] - cum)           # (b,nc,q,h)
    S_c = torch.einsum("bcjhp,bcjn->bchpn", to_end[..., None] * xdt,
                       Br.float())
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (b,nc,h)
    state = torch.zeros((b, h, pd, n), dtype=torch.float32,
                        device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = chunk_decay[:, c, :, None, None] * state + S_c[:, c]
    St = torch.stack(entering, dim=1)                    # (b,nc,h,p,n)
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bcin,bchpn->bcihp", Cr.float(), St)
    out = (y + y_inter).reshape(b, s + pad, h, pd).to(x.dtype)
    return out[:, :s], state


def ssd_scan_backward_ref(inputs, chunk: int, g_y, g_state, needs):
    """Gradients of (x, dt, A, Bm, Cm) (None where ``needs`` is False)
    from the upstream gradients of y and of the final state (either may
    be None): ``ssd_scan_ref`` recomputed under autograd from the inputs
    and differentiated, as the reference trains through XLA's autodiff
    of ``ssd_chunked``."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        y, state = ssd_scan_ref(*ins, chunk)
        outs = [(o, g) for o, g in ((y, g_y), (state, g_state))
                if g is not None]
        wrt = [t for t, n in zip(ins, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in outs],
                                       wrt, [g for _, g in outs],
                                       allow_unused=True))
    return tuple(next(got) if n else None for n in needs)


def sample_inputs(B: int, S: int, H: int, P: int, N: int, seed: int,
                  device, dtype: torch.dtype, strided: bool = True):
    """Inputs for holding the kernel to this version: the reference kernel
    test's distributions (x, Bm, Cm ~ 0.3 N(0, 1), dt ~ U(0.001, 0.1),
    A ~ -U(0.5, 4)) drawn with numpy from ``seed``.  With ``strided`` x,
    Bm and Cm are slices of one (B, S, H*P + 2N) tensor, as ``ssd_block``
    passes its conv output; else contiguous copies of those slices."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy((rng.standard_normal((B, S, H * P + 2 * N))
                            * 0.3).astype(np.float32)).to(device, dtype)
    xs, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, H))
                          .astype(np.float32)).to(device)
    A = torch.from_numpy(-rng.uniform(0.5, 4.0, H).astype(np.float32)) \
        .to(device)
    xs = xs.reshape(B, S, H, P)
    if not strided:
        xs, Bm, Cm = xs.contiguous(), Bm.contiguous(), Cm.contiguous()
    return xs, dt, A, Bm, Cm
