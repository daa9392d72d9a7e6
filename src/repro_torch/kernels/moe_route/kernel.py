"""ctypes wrapper of the CUDA MoE router (``csrc/moe_route.cu``), the
Hopper replacement of the Pallas
``repro.kernels.moe_route.kernel.route_pallas``.

``route_cuda`` checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the launch
in ``LAUNCHES``.  It never falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "moe_route"
LAUNCHES = 0          # launches of the kernel (plain int, reset by callers)
EMAX = 512            # csrc/moe_route.cu EMAX
KMAX = 64             # csrc/moe_route.cu KMAX
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.moe_route_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for limit in (lib.moe_route_emax, lib.moe_route_kmax):
            limit.argtypes, limit.restype = [], ctypes.c_int
        if (lib.moe_route_emax(), lib.moe_route_kmax()) != (EMAX, KMAX):
            raise RuntimeError("moe_route.cu limits differ from kernel.py")
    return lib


def route_cuda(logits: torch.Tensor, k: int, renormalize: bool = True):
    """One launch: logits (T, E) float32 or bfloat16 on CUDA ->
    (weights (T, k) float32, idx (T, k) int32)."""
    global LAUNCHES
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError(f"route_cuda needs a CUDA tensor, got {dev}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"logits have dtype {logits.dtype}; the kernel "
                        "takes float32 or bfloat16")
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("logits are not contiguous")
    T, E = logits.shape
    if not 1 <= E <= EMAX:
        raise ValueError(f"E={E} outside what the kernel holds [1, {EMAX}]")
    if not 1 <= k <= min(E, KMAX):
        raise ValueError(f"k={k} outside [1, {min(E, KMAX)}]")
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.moe_route_launch(
        logits.data_ptr(), _DTYPES[logits.dtype], w.data_ptr(),
        idx.data_ptr(), T, E, k, int(bool(renormalize)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_route launch failed: CUDA error {err}")
    LAUNCHES += 1
    return w, idx
