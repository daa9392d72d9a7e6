"""ctypes wrapper of the CUDA MoE router (``csrc/moe_route.cu``), the
Hopper replacement of the Pallas
``repro.kernels.moe_route.kernel.route_pallas``.

``route_cuda`` checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the launch
in ``LAUNCHES``.  It never falls back to the plain version.  With
``dense_dtype`` the same launch also writes the (T, E) dense combine
weights.

Serving is eager, so the per-call host work is kept small: the library
and its argument types are set up once (``_launcher``), and the stream
is read once a call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "moe_route"
LAUNCHES = 0          # launches of the kernel (plain int, reset by callers)
EMAX = 512            # csrc/moe_route.cu EMAX
KMAX = 64             # csrc/moe_route.cu KMAX
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCH = None        # moe_route_launch with its argument types set


def _launcher():
    """``moe_route_launch``, built and typed on first use, then cached."""
    global _LAUNCH
    if _LAUNCH is None:
        lib = build.load(NAME)
        for limit in (lib.moe_route_emax, lib.moe_route_kmax):
            limit.argtypes, limit.restype = [], ctypes.c_int
        if (lib.moe_route_emax(), lib.moe_route_kmax()) != (EMAX, KMAX):
            raise RuntimeError("moe_route.cu limits differ from kernel.py")
        fn = lib.moe_route_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def route_cuda(logits: torch.Tensor, k: int, renormalize: bool = True,
               dense_dtype: Optional[torch.dtype] = None):
    """One launch: logits (T, E) float32 or bfloat16 on CUDA ->
    (weights (T, k) float32, idx (T, k) int32), and with ``dense_dtype``
    (float32 or bfloat16) also the dense combine weights (T, E): weight
    ``w[t, r]`` at column ``idx[t, r]``, +0 elsewhere."""
    global LAUNCHES
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError(f"route_cuda needs a CUDA tensor, got {dev}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"logits have dtype {logits.dtype}; the kernel "
                        "takes float32 or bfloat16")
    if dense_dtype is not None and dense_dtype not in _DTYPES:
        raise TypeError(f"dense_dtype {dense_dtype}; the kernel writes "
                        "float32 or bfloat16")
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("logits are not contiguous")
    T, E = logits.shape
    if not 1 <= E <= EMAX:
        raise ValueError(f"E={E} outside what the kernel holds [1, {EMAX}]")
    if not 1 <= k <= min(E, KMAX):
        raise ValueError(f"k={k} outside [1, {min(E, KMAX)}]")
    fn = _launcher()
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    dense = None if dense_dtype is None else \
        torch.empty((T, E), dtype=dense_dtype, device=dev)
    err = fn(logits.data_ptr(), _DTYPES[logits.dtype], w.data_ptr(),
             idx.data_ptr(), None if dense is None else dense.data_ptr(),
             0 if dense is None else _DTYPES[dense_dtype], T, E, k,
             int(bool(renormalize)),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_route launch failed: CUDA error {err}")
    if T:                 # no tokens: nothing is launched
        LAUNCHES += 1
    return (w, idx) if dense is None else (w, idx, dense)
