"""The clearing pass as the engine calls it: the ``_prefix_aggregates``
producer as torch ops, then the hierarchical path merge — the CUDA
kernel on CUDA tensors, the plain version on CPU tensors — then the
health mask, applied once after either.

The contract from both (docs/DESIGN.md §3)::

    (rate, best_level, cand_slots, truncated, evict)

with ``cand_slots`` leaf-major ``(n_leaves, k+1)``, ranked (price desc,
seq asc) along the last axis with -1 holes at excluded or sub-floor
ranks.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.kernels.market_clear import kernel as K
from repro_torch.kernels.market_clear import ref as R


def clear(order, sorted_gseg, seg_start, prices, tenants, seqs,
          level_floor, level_off: Tuple[int, ...],
          strides: Tuple[int, ...], owner, limit, k: int, *,
          health=None):
    n_seg = seg_start.shape[0] - 1
    aggs = R._prefix_aggregates(order, sorted_gseg, seg_start, prices,
                                tenants, seqs, n_seg, k)
    level_floor = tuple(level_floor)
    dev = owner.device
    if dev.type == "cuda":
        out = K.clear_cuda(*aggs, level_floor, level_off, strides, owner,
                           limit)
    elif dev.type == "cpu":
        out = R.clear_sorted_from_aggs(aggs, level_floor, level_off,
                                       strides, owner, limit, k)
    else:
        raise ValueError(f"no clearing pass for device {dev}")
    if health is not None:
        out = R.apply_health_mask(health, *out, level_floor, strides,
                                  owner, limit)
    return out
