"""Carry state across between the JAX reference and the port.

The reference's engine state, fleet params and fleet state, given as
numpy arrays (``np.asarray`` of each JAX array), become the port's
tensors on a given device, and the port's state becomes numpy again —
so both implementations can start from one mid-run state, and the
reference's ``schema`` checks can read the port's state.  Dicts, lists
and tuples are walked; dtypes are kept (int32 stays int32).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def to_torch(obj, device: DeviceLike = None):
    """numpy arrays (and numpy or Python scalars) -> tensors."""
    dev = resolve_device(device)
    if isinstance(obj, dict):
        return {k: to_torch(v, dev) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_torch(v, dev) for v in obj)
    arr = np.asarray(obj)
    if arr.dtype == np.float64 or arr.dtype == np.int64:
        raise TypeError(f"64-bit array {arr.dtype} in reference state; "
                        "the state contract is int32/float32")
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def to_numpy(obj):
    """tensors -> numpy arrays (floors stay per-level tuples)."""
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return tuple(to_numpy(v) for v in obj)
    return obj.detach().cpu().numpy()
