"""ctypes wrapper of the CUDA market-clearing kernel
(``csrc/market_clear.cu``), the Hopper replacement of the Pallas
``repro.kernels.market_clear.kernel.clear_pallas``.

``clear_cuda`` takes the ``_prefix_aggregates`` 8-tuple on a CUDA device
and returns what ``ref.clear_sorted_from_aggs`` returns.  It checks
device, dtype, shape and contiguity, allocates the outputs with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch was refused, and counts the launch in
``LAUNCHES``.  It never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

NAME = "market_clear"
LAUNCHES = 0          # launches of the kernel (plain int, reset by callers)

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_void_p, ctypes.c_void_p]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.market_clear_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.market_clear_kmax.restype = ctypes.c_int
        lib.market_clear_lmax.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, name: str, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def clear_cuda(pk, tk, sk, qk, p2, t2, s2, q2,
               level_floor: Sequence[torch.Tensor],
               level_off: Sequence[int], strides: Sequence[int],
               owner: torch.Tensor, limit: torch.Tensor):
    """One launch of the clearing kernel.  Returns ``(rate, best_level,
    cand_slots (n_leaves, k+1), truncated, evict)``."""
    global LAUNCHES
    dev = owner.device
    if dev.type != "cuda":
        raise ValueError(f"clear_cuda needs CUDA tensors, got {dev}")
    n_seg, k = pk.shape
    n_leaves = owner.shape[0]
    n_lvl = len(strides)
    lib = _lib()
    if not 1 <= k <= lib.market_clear_kmax():
        raise ValueError(f"k={k} outside [1, {lib.market_clear_kmax()}]")
    if not 1 <= n_lvl <= lib.market_clear_lmax():
        raise ValueError(f"{n_lvl} levels outside "
                         f"[1, {lib.market_clear_lmax()}]")
    f32, i32 = torch.float32, torch.int32
    _check(pk, "pk", f32, (n_seg, k), dev)
    for name, x in (("tk", tk), ("sk", sk), ("qk", qk)):
        _check(x, name, i32, (n_seg, k), dev)
    _check(p2, "p2", f32, (n_seg,), dev)
    for name, x in (("t2", t2), ("s2", s2), ("q2", q2)):
        _check(x, name, i32, (n_seg,), dev)
    _check(owner, "owner", i32, (n_leaves,), dev)
    _check(limit, "limit", f32, (n_leaves,), dev)
    floor_seg = torch.cat([f.reshape(-1) for f in level_floor])
    _check(floor_seg, "level_floor", f32, (n_seg,), dev)
    if len(level_off) != n_lvl:
        raise ValueError("level_off and strides differ in length")
    rate = torch.empty((n_leaves,), dtype=f32, device=dev)
    best_level = torch.empty((n_leaves,), dtype=i32, device=dev)
    cand_slots = torch.empty((n_leaves, k + 1), dtype=i32, device=dev)
    truncated = torch.empty((n_leaves,), dtype=i32, device=dev)
    evict = torch.empty((n_leaves,), dtype=i32, device=dev)
    c_strides = (ctypes.c_int * n_lvl)(*[int(s) for s in strides])
    c_off = (ctypes.c_int * n_lvl)(*[int(o) for o in level_off])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.market_clear_launch(
        pk.data_ptr(), tk.data_ptr(), sk.data_ptr(), qk.data_ptr(),
        p2.data_ptr(), t2.data_ptr(), s2.data_ptr(), q2.data_ptr(),
        floor_seg.data_ptr(), owner.data_ptr(), limit.data_ptr(),
        ctypes.addressof(c_strides), ctypes.addressof(c_off),
        n_lvl, n_leaves, k,
        rate.data_ptr(), best_level.data_ptr(), cand_slots.data_ptr(),
        truncated.data_ptr(), evict.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"market_clear launch failed: CUDA error {err}")
    LAUNCHES += 1
    return rate, best_level, cand_slots, truncated, evict
