"""ctypes wrapper of the CUDA flash-decode kernel
(``csrc/decode_attention.cu``), the Hopper replacement of the Pallas
``repro.kernels.decode_attention.kernel.decode_attention_pallas``.

``decode_attention_cuda`` checks device, dtype, shape and contiguity,
turns ``pos`` and the window into the range of valid cache positions,
cuts that range into splits (``split_plan``: as many as fill the blocks
that fit on the SMs at once, at most ``MAX_SPLITS``, none under
``MIN_SPLIT`` positions), allocates the output, launches on the current
stream without synchronising, raises if the launch was refused, and
counts the launch in ``LAUNCHES``.  It never falls back to the plain
version.  With more than one split, each split writes its float32
partials to a scratch, and the last split of each group to finish merges
them; it finds out through an int32 arrival counter that it sets back to
0.  So the counters need no memset between launches: ``_workspace``
keeps the counters and the scratch, zeroed once when made, one set a
device and stream for eager launches and one set a graph capture (made,
and zeroed by a node of that graph, at its first launch), so graphs
replay in any order.  A workspace a launch outgrows is replaced and
freed: no graph holds an eager workspace.

``decode_attention_partial_cuda`` is the same kernel over one block of a
cache whose sequence is cut over several ranks (block position ``t`` is
global position ``offset + t``): one launch, counted in ``LAUNCHES``,
that writes the block's float32 ``(o, m, l)`` for the cross-rank merge
(``ref.merge_partials``) in place of the normalised output.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "decode_attention"
LAUNCHES = 0          # launches of the kernel (plain int, reset by callers)
HDMAX = 256           # csrc/decode_attention.cu HDMAX
MAX_SPLITS = 128      # csrc/decode_attention.cu MAX_SPLITS (a plan's cap)
BLOCKS_PER_SM = 2     # resident blocks an SM the split plan aims at
MIN_SPLIT = 32        # fewest positions a split is given
SMEM_PER_SM = 233472  # an H100 SM's shared memory, bytes
SMEM_RESERVED = 1024  # what the card reserves for each resident block
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SLOTS = {}           # (device index, dtype, hd, G) -> (SMs, blocks an SM)
_EAGER = {}           # (device index, stream) -> (counters, scratch)
_CAPTURED = {}        # (device index, stream) -> (capture id, counters,
                      #   scratch) of the capture under way or last made


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        part = lib.decode_attention_partial_launch
        part.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                         + [ctypes.c_float, ctypes.c_void_p])
        part.restype = ctypes.c_int
        lib.decode_attention_smem.argtypes = [ctypes.c_int] * 3
        lib.decode_attention_smem.restype = ctypes.c_int
        cap = lib.decode_attention_capture_id
        cap.argtypes = [ctypes.c_void_p,
                        ctypes.POINTER(ctypes.c_ulonglong)]
        cap.restype = ctypes.c_int
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


def _group_rows(G: int) -> int:
    """Query rows a block holds: G rounded up to 1, 2, 4 or 8, at most 8
    (a larger G takes a block per 8 rows): the kernel's ``GB``."""
    return 1 if G == 1 else 2 if G == 2 else 4 if G <= 4 else 8


def split_plan(n: int, groups: int, sms: int,
               blocks_per_sm: int = BLOCKS_PER_SM):
    """``(splits, split_len)``: ``n`` valid positions cut into ``splits``
    contiguous ranges of ``split_len`` (the last may be shorter, none is
    empty) for ``groups`` blocks' worth of (batch, kv-head, query-row
    chunk) groups on ``sms`` SMs that hold ``blocks_per_sm`` blocks each:
    as many splits as fill those blocks at once (one wave), at most
    ``MAX_SPLITS``, none under ``MIN_SPLIT`` positions unless there is
    only one."""
    splits = max(1, min(blocks_per_sm * sms // groups, MAX_SPLITS,
                        n // MIN_SPLIT))
    split_len = -(-n // splits)
    return -(-n // split_len), split_len


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
    if max(B, K * -(-G // 8)) > 65535:
        raise ValueError(f"B {B} or K {K} (times ceil(G / 8)) above the "
                         "grid's 65,535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return B, S, K, G, hd


def _slots(dev: torch.device, dtype: torch.dtype, hd: int, G: int):
    """``(SMs, blocks an SM)``: the card's SM count and the blocks of
    this shape that fit on an SM at once (by the kernel's shared memory,
    ``decode_attention_smem``), at most ``BLOCKS_PER_SM``."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, dtype, hd, G)
    got = _SLOTS.get(key)
    if got is None:
        smem = _lib().decode_attention_smem(_DTYPES[dtype], hd, G)
        got = _SLOTS[key] = (
            torch.cuda.get_device_properties(idx).multi_processor_count,
            min(BLOCKS_PER_SM,
                max(1, SMEM_PER_SM // (smem + SMEM_RESERVED))))
    return got


def launch_plan(dev: torch.device, dtype: torch.dtype, B: int, K: int,
                G: int, hd: int, n: int):
    """``(splits, split_len)`` of a launch over ``n`` valid positions on
    ``dev``: ``split_plan`` for its B K ceil(G / 8) groups and the blocks
    of its shape that fit on an SM."""
    return split_plan(n, B * K * -(-G // 8), *_slots(dev, dtype, hd, G))


def _capture_id(stream: int) -> int:
    """The id of the graph capture under way on ``stream``."""
    got = ctypes.c_ulonglong(0)
    err = _lib().decode_attention_capture_id(stream, ctypes.byref(got))
    if err != 0:
        raise RuntimeError(f"decode_attention: capture query failed: CUDA "
                           f"error {err}")
    return got.value


def _workspace(dev: torch.device, stream: int, n_cnt: int, n_ws: int):
    """``(counters, scratch)`` for a launch on ``stream``: at least
    ``n_cnt`` int32 arrival counters, all 0 (each launch leaves them 0),
    and ``n_ws`` float32 scratch.  Eager launches share one set a device
    and stream, replaced (the old one freed) when a launch needs more.
    During a graph capture the launches share one set of that capture's
    own, made at its first launch (so zeroed by a node of that graph) and
    kept until the next capture on the stream: two graphs never share
    counters, so they replay in any order."""
    key = (dev.index, stream)
    if torch.cuda.is_current_stream_capturing():
        cap = _capture_id(stream)
        got = _CAPTURED.get(key)
        if got is None or got[0] != cap or got[1].numel() < n_cnt \
                or got[2].numel() < n_ws:
            got = _CAPTURED[key] = (
                cap, torch.zeros(n_cnt, dtype=torch.int32, device=dev),
                torch.empty(n_ws, dtype=torch.float32, device=dev))
        return got[1], got[2]
    got = _EAGER.get(key)
    if got is None or got[0].numel() < n_cnt or got[1].numel() < n_ws:
        got = _EAGER[key] = (
            torch.zeros(max(n_cnt, 1024), dtype=torch.int32, device=dev),
            torch.empty(max(n_ws, 1 << 16), dtype=torch.float32,
                        device=dev))
    return got


def _launch_args(q: torch.Tensor, B: int, K: int, G: int, hd: int,
                 lo: int, hi: int):
    """``(ws, cnt, split_len, splits, stream)`` of one launch: the
    scratch's and counters' addresses (0 for a plan of one split), the
    split plan and the current stream.  Serving calls this once a layer
    and step on the host, so it keeps to cheap calls (the raw stream
    handle, not a ``torch.cuda.Stream`` object)."""
    dev = q.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    splits, split_len = launch_plan(dev, q.dtype, B, K, G, hd, hi - lo + 1)
    if splits == 1:
        return 0, 0, split_len, splits, stream
    groups = B * K * -(-G // 8)
    rows = groups * splits * _group_rows(G)
    cnt, ws = _workspace(dev, stream, groups,  # (m, l) a row, then acc
                         -(-2 * rows // 4) * 4 + rows * hd)  # from 16 B
    return ws.data_ptr(), cnt.data_ptr(), split_len, splits, stream


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, pos: int,
                          window: int = 0) -> torch.Tensor:
    """One launch: q (B, K, G, hd), k/v (B, S, K, hd) on CUDA, all
    float32 or all bfloat16 -> (B, K, G, hd) in q's dtype."""
    global LAUNCHES
    B, S, K, G, hd = _checked(q, k, v, "decode_attention_cuda")
    lo, hi, uniform = valid_range(S, int(pos), int(window))
    ws, cnt, split_len, splits, stream = _launch_args(q, B, K, G, hd, lo, hi)
    out = torch.empty_like(q)
    err = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws, cnt,
        _DTYPES[q.dtype], B, S, K, G, hd, lo, hi, int(uniform), split_len,
        splits, hd ** -0.5, stream)
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
    ws, cnt, split_len, splits, stream = _launch_args(q, B, K, G, hd, lo, hi)
    o = torch.empty((B, K, G, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, K, G), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    err = _lib().decode_attention_partial_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), ws, cnt, _DTYPES[q.dtype], B, S, K, G,
        hd, lo, hi, int(uniform), split_len, splits, hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention partial launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return o, m, l
