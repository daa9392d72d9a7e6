"""Device resolution and the float helpers every module shares."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA.  A CUDA request without CUDA raises: the
    port never drops to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device=None means 'cuda', but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The reference's XLA CPU backend contracts multiply-adds into FMA
    instructions, so a float32 formula there rounds once where eager
    PyTorch rounds twice.  The product of two float32 values is exact
    in float64, so computing in float64 and rounding to float32 gives
    the fused result (double rounding differs only when the float64 sum
    lands exactly on a float32 midpoint, about 2**-29 of inputs)."""
    def f64(x):   # a Python constant is a float32 in the reference
        return x.double() if isinstance(x, torch.Tensor) \
            else float(np.float32(x))
    out = f64(a) * f64(b) + f64(c)
    return out.float()


def recip32(c: float) -> float:
    """float32 reciprocal of a constant, as a Python float.

    The reference's XLA CPU backend rewrites ``x / c`` for a constant
    ``c`` into ``x * (1 / c)`` with the reciprocal rounded to float32,
    which rounds differently from a true division; the port writes
    those divisions as ``x * recip32(c)``."""
    return float(np.float32(1.0) / np.float32(c))


def f32_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose signed order is the order ``lax.sort`` gives
    float32 ``x``: it maps ``-0.0`` to ``+0.0`` and every NaN to one
    quiet NaN, then compares by IEEE total order — so the two zeros tie
    and NaNs sort last.  An integer key lets the sort combine it with
    other keys in one int64."""
    x = torch.where(x == 0, 0.0, x)
    x = torch.where(torch.isnan(x), float("nan"), x).to(torch.float32)
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def arange32(n: int, device: Optional[torch.device]) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def scatter_drop(base: torch.Tensor, idx: torch.Tensor,
                 src) -> torch.Tensor:
    """``base.at[idx].set(src, mode="drop")`` out of place: indices
    outside ``[0, len(base))`` are dropped.  They are sent to one
    trailing spill slot, which is cut off after the write.  Valid
    indices must be unique, as in every caller."""
    n = base.shape[0]
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    out = torch.cat([base, base[:1]])
    if not isinstance(src, torch.Tensor):
        src = torch.full(idx.shape, src, dtype=base.dtype,
                         device=base.device)
    out[idx] = src.to(base.dtype)
    return out[:n]


def scatter_add_drop(n: int, idx: torch.Tensor, src: torch.Tensor
                     ) -> torch.Tensor:
    """Integer ``zeros(n).at[idx].add(src, mode="drop")``: integer sums
    do not depend on the order of the adds, so atomics are exact."""
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    out = torch.zeros(n + 1, dtype=src.dtype, device=src.device)
    out.index_add_(0, idx, src)
    return out[:n]


def seq_scatter_add(base: torch.Tensor, idx: torch.Tensor,
                    src: torch.Tensor) -> torch.Tensor:
    """float32 ``base.at[idx].add(src, mode="drop")`` with each target's
    adds done one at a time in the order of ``idx``'s positions — the
    order of the reference's CPU scatter.  Float addition is not
    associative, so atomics (whose order changes from run to run) or a
    parallel scan would give other bits.  Loops over the rank within a
    target (one host read of the largest group)."""
    n = base.shape[0]
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    tgt = torch.where(ok, idx, n)
    order = torch.sort(tgt, stable=True).indices
    tgt_s = tgt[order]
    src_s = src[order]
    counts = torch.bincount(tgt_s, minlength=n + 1)[:n]
    starts = torch.cumsum(counts, 0) - counts
    out = base.clone()
    depth = int(counts.max()) if n > 0 and src.numel() > 0 else 0
    for r in range(depth):
        has = counts > r
        pos = torch.where(has, starts + r, 0)
        out = torch.where(has, out + src_s[pos], out)
    return out
