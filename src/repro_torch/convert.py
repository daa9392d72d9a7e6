"""Carry state across between the JAX reference and the port.

The reference's engine state, fleet params and fleet state, given as
numpy arrays (``np.asarray`` of each JAX array), become the port's
tensors on a given device, and the port's state becomes numpy again —
so both implementations can start from one mid-run state, and the
reference's ``schema`` checks can read the port's state.  A model's
parameters and a train state cross the same way.  Dicts, lists
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


def model_params_from_jax(params_np, device: DeviceLike = None):
    """The reference's ``models.model.init_params`` tree, given as numpy
    (``np.asarray`` of each leaf), as the port's parameter tree on
    ``device``: the same head/blocks/tail layout and dtypes.  bfloat16
    leaves come from numpy as ``ml_dtypes.bfloat16``, which torch does not
    read; they go through float32 (exact for bfloat16) and back."""
    dev = resolve_device(device)
    if isinstance(params_np, dict):
        return {k: model_params_from_jax(v, dev) for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return type(params_np)(model_params_from_jax(v, dev)
                               for v in params_np)
    arr = np.asarray(params_np)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return to_torch(arr, dev)


def train_state_from_jax(state_np, device: DeviceLike = None):
    """The reference's train state ``{"params", "m", "v", "step"}``, given
    as numpy, as the port's on ``device``: params, m and v through
    ``model_params_from_jax`` (bfloat16 state included), ``step`` a 0-d
    int32 tensor."""
    dev = resolve_device(device)
    out = {k: model_params_from_jax(state_np[k], dev)
           for k in ("params", "m", "v")}
    out["step"] = to_torch(np.asarray(state_np["step"], np.int32), dev)
    return out
