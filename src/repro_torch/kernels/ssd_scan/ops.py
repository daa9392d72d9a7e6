"""The SSD scan as the model calls it: the CUDA kernel on CUDA tensors,
the plain version on CPU tensors, an error on any other device.

The kernel reads x, Bm and Cm through their batch and token strides, so
the slices of ``ssd_block``'s conv output go in without a copy; a layout
it cannot read (a non-unit inner stride) is refused by the wrapper."""
from __future__ import annotations

from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref as R


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 256):
    """x (B,S,H,P); dt (B,S,H) f32; A (H,) f32; Bm/Cm (B,S,N) ->
    (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32)."""
    dev = x.device
    if dev.type == "cuda":
        return K.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk)
    if dev.type == "cpu":
        return R.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    raise ValueError(f"no SSD scan for device {dev}")
