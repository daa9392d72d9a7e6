"""ctypes wrapper of the CUDA flash-decode kernel
(``csrc/decode_attention.cu``), the Hopper replacement of the Pallas
``repro.kernels.decode_attention.kernel.decode_attention_pallas``.

``decode_attention_cuda`` checks device, dtype, shape and contiguity,
turns ``pos`` and the window into the range of valid cache positions,
cuts that range into splits (``split_plan``: about four blocks an SM,
at most ``MAX_SPLITS``, one thread-block cluster of splits per (batch,
kv-head) that merges them in shared memory), allocates the output with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch was refused, and counts the launch in
``LAUNCHES``.  It never falls back to the plain version.

``decode_attention_partial_cuda`` is the same kernel over one block of a
cache whose sequence is cut over several ranks (block position ``t`` is
global position ``offset + t``): one launch, counted in ``LAUNCHES``,
that writes the block's float32 ``(o, m, l)`` for the cross-rank merge
(``ref.merge_partials``) in place of the normalised output.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

NAME = "decode_attention"
LAUNCHES = 0          # launches of the kernel (plain int, reset by callers)
HDMAX = 256           # csrc/decode_attention.cu HDMAX
MAX_SPLITS = 8        # csrc/decode_attention.cu MAX_SPLITS (cluster size)
BLOCKS_PER_SM = 4     # blocks the split plan aims at on each SM
MIN_SPLIT = 64        # fewest positions a split is given
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = {}             # device index -> SM count


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        part = lib.decode_attention_partial_launch
        part.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                         + [ctypes.c_float, ctypes.c_void_p])
        part.restype = ctypes.c_int
        for limit in (lib.decode_attention_hdmax,
                      lib.decode_attention_max_splits):
            limit.argtypes, limit.restype = [], ctypes.c_int
        if (lib.decode_attention_hdmax(),
                lib.decode_attention_max_splits()) != (HDMAX, MAX_SPLITS):
            raise RuntimeError("decode_attention.cu limits differ from "
                               "kernel.py")
    return lib


def valid_range(S: int, pos: int, window: int):
    """``(lo, hi, uniform)``: the cache positions the mask keeps are
    ``lo..hi``; with none kept, the reference's softmax is uniform over
    all S positions, which the kernel gives with every score 0 (in
    partial mode, for one block of a cut cache with ``pos`` taken
    relative to the block, it then reports m = -2**30: the block weighs
    nothing beside one that holds a valid position)."""
    hi = min(pos, S - 1)
    lo = max(0, pos - window + 1) if window else 0
    if lo > hi:
        return 0, S - 1, True
    return lo, hi, False


def split_plan(n: int, groups: int, sms: int):
    """``(splits, split_len)``: ``n`` valid positions cut into ``splits``
    contiguous ranges of ``split_len`` (the last may be shorter, none is
    empty) for ``groups`` (batch, kv-head) pairs on ``sms`` SMs: at most
    ``BLOCKS_PER_SM`` blocks an SM and ``MAX_SPLITS`` splits, none under
    ``MIN_SPLIT`` positions unless there is only one."""
    splits = max(1, min(BLOCKS_PER_SM * sms // groups, MAX_SPLITS,
                        n // MIN_SPLIT))
    split_len = -(-n // splits)
    return -(-n // split_len), split_len


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _checked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             fn: str):
    """(B, S, K, G, hd) of q (B, K, G, hd) and k/v (B, S, K, hd), after
    the checks every launch needs: one CUDA device, one dtype the kernel
    takes, the shapes, the limits and contiguity."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {dev}")
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, q on {dev}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, q {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B, K, G, hd) and "
                         "two (B, S, K, hd)")
    B, K, G, hd = q.shape
    S = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, K, hd):
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if not 1 <= hd <= HDMAX:
        raise ValueError(f"head dim {hd} outside [1, {HDMAX}]")
    if S < 1:
        raise ValueError("empty cache")
    if max(B, K) > 65535:
        raise ValueError(f"B {B} or K {K} above the grid's 65,535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return B, S, K, G, hd


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, pos: int,
                          window: int = 0) -> torch.Tensor:
    """One launch: q (B, K, G, hd), k/v (B, S, K, hd) on CUDA, all
    float32 or all bfloat16 -> (B, K, G, hd) in q's dtype."""
    global LAUNCHES
    B, S, K, G, hd = _checked(q, k, v, "decode_attention_cuda")
    dev = q.device
    lo, hi, uniform = valid_range(S, int(pos), int(window))
    splits, split_len = split_plan(hi - lo + 1, B * K, _sm_count(dev))
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, S, K, G, hd, lo, hi, int(uniform), split_len,
        splits,
        float(np.float32(hd ** -0.5)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def decode_attention_partial_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, pos: int, window: int = 0,
                                  offset: int = 0):
    """One launch over one block of a cut cache: q (B, K, G, hd), k/v
    (B, S_block, K, hd) on CUDA, all float32 or all bfloat16, the block's
    position ``t`` the global position ``offset + t`` -> float32 ``(o
    (B, K, G, hd), m (B, K, G), l (B, K, G))``, what
    ``ref.decode_attention_partial_ref`` computes.  ``pos - offset`` may
    be negative or past the block's end: the block then holds no valid
    position and reports ``m = -2**30``."""
    global LAUNCHES
    B, S, K, G, hd = _checked(q, k, v, "decode_attention_partial_cuda")
    dev = q.device
    lo, hi, uniform = valid_range(S, int(pos) - int(offset), int(window))
    splits, split_len = split_plan(hi - lo + 1, B * K, _sm_count(dev))
    o = torch.empty((B, K, G, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, K, G), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    err = _lib().decode_attention_partial_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), _DTYPES[q.dtype], B, S, K, G, hd, lo,
        hi, int(uniform), split_len, splits, float(np.float32(hd ** -0.5)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention partial launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return o, m, l
