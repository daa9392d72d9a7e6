"""ctypes wrapper of the CUDA SSD chunked scan (``csrc/ssd_scan.cu``), the
Hopper replacement of the Pallas
``repro.kernels.ssd_scan.kernel.ssd_scan_pallas``.

``ssd_scan_cuda`` checks device, dtype, shape and layout, allocates the
outputs and the float32 scratch (each chunk's state, each chunk's decay)
with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the call in
``LAUNCHES``.  One call runs three grid passes (each chunk's own state;
the states carried over the chunks; each chunk's outputs) and counts as
one launch of the kernel.  It never falls back to the plain version.

x, Bm and Cm may be strided along batch and tokens (``ssd_block`` hands
in slices of one conv output); within a token, x must be (H, P) with
unit stride along P and Bm/Cm unit stride along N.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
LAUNCHES = 0          # launches of the kernel (plain int, reset by callers)
QMAX = 1024           # csrc/ssd_scan.cu QMAX: the longest chunk
NMAX = 256            # csrc/ssd_scan.cu NMAX: the largest state size
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for limit in (lib.ssd_scan_qmax, lib.ssd_scan_nmax):
            limit.argtypes, limit.restype = [], ctypes.c_int
        if (lib.ssd_scan_qmax(), lib.ssd_scan_nmax()) != (QMAX, NMAX):
            raise RuntimeError("ssd_scan.cu limits differ from kernel.py")
    return lib


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """One launch: x (B,S,H,P), Bm/Cm (B,S,N), all float32 or all
    bfloat16; dt (B,S,H) and A (H,) float32, contiguous; on CUDA ->
    (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) float32)."""
    global LAUNCHES
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {dev}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes float32 "
                        "or bfloat16")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, x {x.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; expected float32")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) or \
            Bm.dim() != 3 or tuple(Bm.shape) != (B, S, N) or \
            tuple(Cm.shape) != (B, S, N):
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}: expected "
            "(B,S,H,P), (B,S,H), (H,) and two (B,S,N)")
    if min(B, S, H, P) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if not 1 <= N <= NMAX:
        raise ValueError(f"state size N={N} outside [1, {NMAX}]")
    if not 1 <= chunk <= QMAX:
        raise ValueError(f"chunk={chunk} outside [1, {QMAX}]")
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError(f"x strides {x.stride()}: a token must be (H, P) "
                         "contiguous")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} strides {t.stride()}: N must have "
                             "unit stride")
    for name, t in (("dt", dt), ("A", A)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    n_chunks = -(-S // chunk)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    states = torch.empty((B, n_chunks, H, P, N), dtype=torch.float32,
                         device=dev)
    cdecay = torch.empty((B, n_chunks, H), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), states.data_ptr(),
        cdecay.data_ptr(),
        _DTYPES[x.dtype], B, S, H, P, N, chunk,
        x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
        Cm.stride(0), Cm.stride(1),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y, state
