"""The SSD scan as the model calls it: the CUDA kernels on CUDA tensors,
the plain version on CPU tensors (and on ``meta`` ones, where it gives
the shapes and dtypes: the dry run traces there), an error on any other
device; with a gradient on either.

The kernel reads x, Bm and Cm through their batch and token strides, so
the slices of ``ssd_block``'s conv output go in without a copy; a layout
it cannot read (a non-unit inner stride) is refused by the wrapper.

The kernel's outputs carry no ``grad_fn``, so ``ssd_scan`` is an
``autograd.Function`` that saves only its inputs.  Its backward takes
the route of its forward: on CUDA tensors the backward kernel
(``kernel.ssd_scan_backward_cuda``), which differentiates the kernel's
own forward (C·Bᵀ in float32, W rounded to bfloat16 only as a product's
operand), with no fallback; on ``cpu`` and ``meta`` tensors the plain
version recomputed under autograd (``ref.ssd_scan_backward_ref``), the
gradient of the plain chunked formula, which XLA's autodiff of the
reference's ``ssd_chunked`` also gives (the TPU kernel has no backward).
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
    be None): one launch of the backward kernel on CUDA tensors, the
    plain version under autograd on ``cpu`` and ``meta`` ones."""
    x = inputs[0]
    dev = x.device
    if dev.type in ("cpu", "meta"):
        return R.ssd_scan_backward_ref(inputs, chunk, g_y, g_state, needs)
    if dev.type != "cuda":
        raise ValueError(f"no SSD scan backward for device {dev}")
    if g_y is None:                   # only the final state has a gradient
        g_y = torch.zeros(x.shape, dtype=x.dtype, device=dev)
    if g_state is not None:
        g_state = g_state.contiguous()
    grads = K.ssd_scan_backward_cuda(*inputs, chunk, g_y.contiguous(),
                                     g_state)
    return tuple(g if n else None for g, n in zip(grads, needs))


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
