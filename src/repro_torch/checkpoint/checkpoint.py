"""Checkpointing: atomic, step-numbered, async-capable — the twin of
``repro.checkpoint.checkpoint``.

A state tree (nested dicts, tuples and lists of tensors) is flattened to
path-keyed numpy arrays in one ``.npz`` per step, written to a temp file
and atomically renamed, so a crash mid-write never corrupts the latest
checkpoint.  The keys are the reference's (``jax.tree_util.keystr`` of
each leaf's path: ``['eng']['owner']``, ``['eng']['floor'][0]``) and
every leaf keeps its own dtype, 0-d scalars included, so a snapshot
written by either implementation restores in the other.  numpy has no
bfloat16: the reference's bfloat16 leaves (``ml_dtypes``) reach the file
as raw 2-byte records (``V2``), and the port writes and reads its
bfloat16 leaves as the same records.
"""
from __future__ import annotations

import os
import pathlib
import re
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import walk


_BF16_RECORD = np.dtype("V2")     # how a bfloat16 leaf lies in the file


def _host(leaf: torch.Tensor) -> np.ndarray:
    """An owned host copy of ``leaf``: the state goes on changing in
    place (``adamw_update``) while a writer thread saves the copy."""
    leaf = leaf.detach().to("cpu", copy=True)
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(_BF16_RECORD)
    return leaf.numpy()


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    """Path-keyed host copies of every leaf (the device->host copy)."""
    return {key: _host(leaf) for key, _, leaf in walk(tree)}


def _unflatten(template: Any, flat: Dict[str, np.ndarray], dev, prefix=""):
    """``template``'s structure with each leaf taken from ``flat``, cast
    to the template leaf's dtype and put on ``dev``."""
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, dev, f"{prefix}[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten(v, flat, dev, f"{prefix}[{i}]")
            for i, v in enumerate(template))
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix}")
    arr = np.array(flat[prefix])        # an owned copy; 0-d stays 0-d
    if arr.dtype == _BF16_RECORD:
        if template.dtype != torch.bfloat16:
            raise TypeError(f"leaf {prefix}: bfloat16 records in the "
                            f"checkpoint, {template.dtype} in the template")
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(device=dev, dtype=template.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def _path(self, step: int) -> pathlib.Path:
        return self.dir / f"ckpt_{step:08d}.npz"

    def save(self, step: int, state: Any, *, blocking: bool = True) -> None:
        flat = _flatten(state)          # device->host copy happens here
        if blocking:
            self._write(step, flat)
        else:
            self.wait()                 # one in-flight write at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._thread.start()

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        tmp = self.dir / f".tmp_{step}_{os.getpid()}.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, self._path(step))   # atomic
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            try:
                self._path(s).unlink()
            except FileNotFoundError:
                pass

    def all_steps(self):
        out = []
        for p in self.dir.glob("ckpt_*.npz"):
            m = re.match(r"ckpt_(\d+)\.npz", p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any,
                device: DeviceLike = None) -> Any:
        """Load ``step`` and rebuild ``template``'s tree from it, each
        leaf in the template's dtype on ``device`` (``None`` = CUDA)."""
        dev = resolve_device(device)
        with np.load(self._path(step)) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten(template, flat, dev)
