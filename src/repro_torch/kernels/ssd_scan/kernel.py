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

``ssd_scan_backward_cuda`` is the same source's backward (one launch:
the forward's passes 1-2 again, then the state gradients and each
chunk's input gradients), counted in ``BACKWARD_LAUNCHES``.  The Pallas
kernel has no backward; this one gives the training path's
``_SSDScan.backward`` a kernel on the card.  Its pass over each chunk's
position pairs runs a block per (64 positions, head group, batch x
chunk); ``_groups`` picks the number of head groups from the SM count,
and ``groups=`` overrides it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
LAUNCHES = 0          # launches of the kernel (plain int, reset by callers)
BACKWARD_LAUNCHES = 0  # launches of the backward (likewise)
QMAX = 1024           # csrc/ssd_scan.cu QMAX: the longest chunk
NMAX = 256            # csrc/ssd_scan.cu NMAX: the largest state size
PMAX_BWD = 64         # csrc/ssd_scan.cu kPMaxBwd: the backward's largest P
NMAX_BWD = 128        # csrc/ssd_scan.cu kNMaxBwd: the backward's largest N
# The bfloat16 backward against the plain version on the same card
# tensors, as a share of each gradient's largest magnitude.  Both routes
# round to bfloat16 (the plain one C·Bᵀ and each gradient it casts back,
# the kernel W, R_c, S_c and each head group's float32 sum of dG as
# product operands, and its outputs), 2**-9 relative each, in sums of up
# to Q x H terms.  dG rounds once a head group, so gBm and gCm depend on
# the split into groups (``_groups``, from the SM count), which the card
# tests run at 1, 3 and H groups.  The kernel read 3.8e-3 to 7.2e-3 of
# the largest magnitude (the worst gradient of each case) at the card
# tests' shapes and at (4, 4,096, 48, 64, N 128), with and without a
# final-state gradient, at 1, 3 and H groups and ``_groups``' own, on an
# NVIDIA H100 80GB HBM3 at 700 W.  2.8x the largest.
BWD_BF16_TOL = 2e-2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for limit in (lib.ssd_scan_qmax, lib.ssd_scan_nmax,
                      lib.ssd_scan_bwd_pmax, lib.ssd_scan_bwd_nmax):
            limit.argtypes, limit.restype = [], ctypes.c_int
        if (lib.ssd_scan_qmax(), lib.ssd_scan_nmax(), lib.ssd_scan_bwd_pmax(),
                lib.ssd_scan_bwd_nmax()) != (QMAX, NMAX, PMAX_BWD, NMAX_BWD):
            raise RuntimeError("ssd_scan.cu limits differ from kernel.py")
        bwd = lib.ssd_scan_bwd_launch
        bwd.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
                        + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        ws = lib.ssd_scan_bwd_workspace
        ws.argtypes, ws.restype = [ctypes.c_int] * 8, ctypes.c_longlong
    return lib


def _check(who, x, dt, A, Bm, Cm, chunk):
    """Refuse what the kernel cannot take; returns (B, S, H, P, N)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {dev}")
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
    return B, S, H, P, N


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """One launch: x (B,S,H,P), Bm/Cm (B,S,N), all float32 or all
    bfloat16; dt (B,S,H) and A (H,) float32, contiguous; on CUDA ->
    (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) float32)."""
    global LAUNCHES
    B, S, H, P, N = _check("ssd_scan_cuda", x, dt, A, Bm, Cm, chunk)
    dev = x.device
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


def _groups(B, S, H, chunk, sms) -> int:
    """Head groups of the backward's pass 3' on a card of ``sms``
    multiprocessors: enough blocks for one column-kernel block an SM (it
    fills an SM; fewer groups form C·Bᵀ and the dG products fewer
    times), each group forming C·Bᵀ once a tile pair and summing dG, gB
    and gC over its ceil(H / groups) heads (every group non-empty)."""
    tiles = -(-chunk // 64) * B * -(-S // chunk)
    want = min(H, max(1, -(-sms // tiles)))
    return -(-H // -(-H // want))


def ssd_scan_backward_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                           Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                           g_y: torch.Tensor, g_state=None, groups=None):
    """One launch of the backward: the inputs as ``ssd_scan_cuda`` takes
    them (P <= 64, N <= 128), ``g_y`` (B,S,H,P) in x's dtype with a token
    (H, P) contiguous, ``g_state`` (B,H,P,N) float32 or None (zero),
    ``groups`` the head groups (default ``_groups``; each of
    ceil(H / groups) heads but the last, none empty) -> (gx (B,S,H,P),
    gdt (B,S,H) float32, gA (H,) float32, gBm and gCm (B,S,N)), gx, gBm
    and gCm in x's dtype, all contiguous."""
    global BACKWARD_LAUNCHES
    B, S, H, P, N = _check("ssd_scan_backward_cuda", x, dt, A, Bm, Cm, chunk)
    dev = x.device
    if P > PMAX_BWD or N > NMAX_BWD:
        raise ValueError(f"P={P}, N={N}: the backward takes P <= "
                         f"{PMAX_BWD} and N <= {NMAX_BWD}")
    if g_y.device != dev or g_y.dtype != x.dtype or \
            tuple(g_y.shape) != (B, S, H, P):
        raise ValueError(f"g_y {tuple(g_y.shape)} {g_y.dtype} on "
                         f"{g_y.device}: expected {(B, S, H, P)} {x.dtype} "
                         f"on {dev}")
    if g_y.stride(3) != 1 or g_y.stride(2) != P:
        raise ValueError(f"g_y strides {g_y.stride()}: a token must be "
                         "(H, P) contiguous")
    if g_state is not None and (
            g_state.device != dev or g_state.dtype != torch.float32
            or tuple(g_state.shape) != (B, H, P, N)
            or not g_state.is_contiguous()):
        raise ValueError(f"g_state {tuple(g_state.shape)} {g_state.dtype} on "
                         f"{g_state.device}: expected a contiguous "
                         f"{(B, H, P, N)} float32 on {dev}")
    if groups is None:
        groups = _groups(B, S, H, chunk, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    elif not 1 <= groups <= H or (groups - 1) * -(-H // groups) >= H:
        raise ValueError(f"groups={groups} for H={H}: each group takes "
                         "ceil(H / groups) heads and none may be empty")
    lib = _lib()
    ws = torch.empty(lib.ssd_scan_bwd_workspace(B, S, H, P, N, chunk, groups,
                                                _DTYPES[x.dtype]),
                     dtype=torch.float32, device=dev)
    gx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    gdt = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    gA = torch.empty((H,), dtype=torch.float32, device=dev)
    gB = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    gC = torch.empty((B, S, N), dtype=x.dtype, device=dev)
    err = lib.ssd_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), g_y.data_ptr(),
        None if g_state is None else g_state.data_ptr(),
        gx.data_ptr(), gdt.data_ptr(), gA.data_ptr(), gB.data_ptr(),
        gC.data_ptr(), ws.data_ptr(),
        _DTYPES[x.dtype], B, S, H, P, N, chunk, groups,
        x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
        Cm.stride(0), Cm.stride(1), g_y.stride(0), g_y.stride(1),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward launch failed: CUDA error "
                           f"{err}")
    BACKWARD_LAUNCHES += 1
    return gx, gdt, gA, gB, gC
