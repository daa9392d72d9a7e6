"""The SSD scan as the model calls it: the CUDA kernel on CUDA tensors,
the plain version on CPU tensors (and on ``meta`` ones, where it gives
the shapes and dtypes: the dry run traces there), an error on any other
device; with a gradient on either.

The kernel reads x, Bm and Cm through their batch and token strides, so
the slices of ``ssd_block``'s conv output go in without a copy; a layout
it cannot read (a non-unit inner stride) is refused by the wrapper.

The kernel's outputs carry no ``grad_fn``, so ``ssd_scan`` is an
``autograd.Function``.  The forward's outputs always come from the
kernel (on CUDA).  Its backward recomputes the plain version's chunked
formula under autograd from the saved inputs and differentiates it:
what the reference trains through, XLA's autodiff of ``ssd_chunked``
(the TPU kernel has no backward).  In bfloat16 the two differ: the
kernel takes ``C·Bᵀ`` in float32 and the chunked formula in bfloat16,
so the backward is the gradient of a function that is within the bf16
tolerance (4e-2) of the forward, not of the forward itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref as R


def _scan(x, dt, A, Bm, Cm, chunk: int):
    dev = x.device
    if dev.type == "cuda":
        return K.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk)
    if dev.type in ("cpu", "meta"):
        return R.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    raise ValueError(f"no SSD scan for device {dev}")


def ssd_scan_backward(inputs, chunk: int, g_y, g_state, needs):
    """Gradients of (x, dt, A, Bm, Cm) (None where ``needs`` is False)
    from the upstream gradients of y and of the final state (either may
    be None), through the plain version recomputed under autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        y, state = R.ssd_scan_ref(*ins, chunk)
        outs = [(o, g) for o, g in ((y, g_y), (state, g_state))
                if g is not None]
        wrt = [t for t, n in zip(ins, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in outs],
                                       wrt, [g for _, g in outs],
                                       allow_unused=True))
    return tuple(next(got) if n else None for n in needs)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, state = _scan(x, dt, A, Bm, Cm, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, g_y, g_state):
        needs = ctx.needs_input_grad[:5]
        grads = ssd_scan_backward(ctx.saved_tensors, ctx.chunk, g_y,
                                  g_state, needs)
        return (*grads, None)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 256):
    """x (B,S,H,P); dt (B,S,H) f32; A (H,) f32; Bm/Cm (B,S,N) ->
    (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32)."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
