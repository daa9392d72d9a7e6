"""ctypes wrapper of the CUDA market-clearing kernel
(``csrc/market_clear.cu``), the Hopper replacement of the Pallas
``repro.kernels.market_clear.kernel.clear_pallas``.

``clear_cuda`` takes the ``_prefix_aggregates`` 8-tuple on a CUDA device
and returns what ``ref.clear_sorted_from_aggs`` returns.  It checks
device, dtype, shape and contiguity, allocates the outputs with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch was refused, and counts the launch in
``LAUNCHES``.  It never falls back to the plain version.

The kernel runs a block per range of ``LEAVES_PER_BLOCK`` leaves.
``leaf_plan`` gives each block, per level, the contiguous range of its
leaves' ancestors under the reference's parent map and where the block
stages their lists; ``_tree_plan`` builds that table on the device once
per tree (the first call for a tree copies it to the card, so warm up
before capturing a CUDA graph).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

NAME = "market_clear"
LAUNCHES = 0          # launches of the kernel (plain int, reset by callers)

_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_void_p, ctypes.c_void_p]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6)
LEAVES_PER_BLOCK = 32   # 313 blocks at 10,000 leaves: two or more an SM
_LIMITS: Dict[str, int] = {}      # the library's KMAX and LMAX


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.market_clear_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.market_clear_kmax.restype = ctypes.c_int
        lib.market_clear_lmax.restype = ctypes.c_int
        _LIMITS.update(kmax=lib.market_clear_kmax(),
                       lmax=lib.market_clear_lmax())
    return lib


def _chain(leaf: np.ndarray, strides: Sequence[int]) -> np.ndarray:
    """The reference's ancestor chain of each leaf: n[0] = leaf //
    stride[0], n[d+1] = n[d] * stride[d] // stride[d+1]."""
    nodes = [leaf // strides[0]]
    for d in range(len(strides) - 1):
        nodes.append(nodes[-1] * strides[d] // strides[d + 1])
    return np.stack(nodes, axis=-1)


def leaf_plan(strides: Sequence[int], n_leaves: int,
              per_block: int = LEAVES_PER_BLOCK) -> np.ndarray:
    """(n_blocks, 3, n_lvl) int32: per block and level, the first
    ancestor node of its leaf range, the count of ancestor nodes (the
    chain is monotone, so they are one contiguous range), and the
    block's staging offset of that level's lists (the counts of the
    levels below it)."""
    first = np.arange(0, n_leaves, per_block, dtype=np.int64)
    last = np.minimum(first + per_block, n_leaves) - 1
    lo = _chain(first, strides)
    cnt = _chain(last, strides) - lo + 1
    soff = np.cumsum(cnt, axis=1) - cnt
    return np.stack([lo, cnt, soff], axis=1).astype(np.int32)


def plan_sizes(plan: np.ndarray) -> Tuple[int, int]:
    """``(max_hi, own_max)``: the most nodes of one level above level 0
    (of level 0 when it is the root) in any block, and the most nodes a
    block stages over all levels; they size the block's shared memory."""
    cnt = plan[:, 1, :]
    hi = cnt[:, 1:] if cnt.shape[1] > 1 else cnt
    return int(hi.max()), int(cnt.sum(axis=1).max())


@dataclass(frozen=True)
class _TreePlan:
    table: torch.Tensor           # leaf_plan on the device
    max_hi: int
    own_max: int
    c_strides: ctypes.Array
    c_off: ctypes.Array


_PLANS: Dict[tuple, _TreePlan] = {}


def _tree_plan(strides, level_off, n_leaves: int,
               dev: torch.device) -> _TreePlan:
    key = (tuple(strides), tuple(level_off), n_leaves, dev.index)
    plan = _PLANS.get(key)
    if plan is None:
        table = leaf_plan(strides, n_leaves)
        n_lvl = len(strides)
        plan = _TreePlan(
            torch.from_numpy(table).to(dev), *plan_sizes(table),
            (ctypes.c_int * n_lvl)(*[int(s) for s in strides]),
            (ctypes.c_int * n_lvl)(*[int(o) for o in level_off]))
        _PLANS[key] = plan
    return plan


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
    if not 1 <= k <= _LIMITS["kmax"]:
        raise ValueError(f"k={k} outside [1, {_LIMITS['kmax']}]")
    if not 1 <= n_lvl <= _LIMITS["lmax"]:
        raise ValueError(f"{n_lvl} levels outside [1, {_LIMITS['lmax']}]")
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
    plan = _tree_plan(strides, level_off, n_leaves, dev)
    rate = torch.empty((n_leaves,), dtype=f32, device=dev)
    best_level = torch.empty((n_leaves,), dtype=i32, device=dev)
    cand_slots = torch.empty((n_leaves, k + 1), dtype=i32, device=dev)
    truncated = torch.empty((n_leaves,), dtype=i32, device=dev)
    evict = torch.empty((n_leaves,), dtype=i32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.market_clear_launch(
        pk.data_ptr(), tk.data_ptr(), sk.data_ptr(), qk.data_ptr(),
        p2.data_ptr(), t2.data_ptr(), s2.data_ptr(), q2.data_ptr(),
        floor_seg.data_ptr(), owner.data_ptr(), limit.data_ptr(),
        plan.table.data_ptr(), ctypes.addressof(plan.c_strides),
        ctypes.addressof(plan.c_off), n_lvl, n_leaves, k,
        LEAVES_PER_BLOCK, plan.max_hi, plan.own_max,
        rate.data_ptr(), best_level.data_ptr(), cand_slots.data_ptr(),
        truncated.data_ptr(), evict.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"market_clear launch failed: CUDA error {err}")
    LAUNCHES += 1
    return rate, best_level, cand_slots, truncated, evict
