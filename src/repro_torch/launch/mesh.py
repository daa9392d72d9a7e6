"""Device meshes over ``torch.distributed``, twin of ``repro.launch.mesh``.

``make_mesh(shape, axes)`` is a ``DeviceMesh`` over ranks ``0 ..
prod(shape) - 1`` of the default process group, laid out row-major as
``jax.make_mesh`` lays out its devices.  Every rank of the default group
calls it, because each of the mesh's groups is made by a collective
``new_group``; a rank outside the mesh gets ``get_coordinate() is None``
and sits the step out.

Without a default group, ``make_mesh`` makes one: from the
environment where a launcher such as ``torchrun`` set ``WORLD_SIZE``
above 1, else a one-rank one over a ``HashStore``; gloo for CPU tensors
and, where CUDA is present, NCCL for CUDA tensors in the same group.  So
a one-device trainer needs no launcher, as the reference's needs none.
In a group of more than one
rank, CUDA work binds each rank to its own card (``LOCAL_RANK``, as a
launcher such as ``torchrun`` sets it, else the rank modulo the cards on
the host): NCCL refuses two ranks on one card.  ``spawn_local`` runs an SPMD
function on ``n`` local ranks (gloo, and NCCL for CUDA tensors where
asked, over a ``FileStore`` in a temporary directory: no TCP port to
collide on), the counterpart of the reference's
``xla_force_host_platform_device_count``.

``make_production_mesh`` is the reference's 256- or 512-device mesh as
a ``DeviceMesh`` over the default group, which must have that many
ranks: the dry run (``launch/dryrun.py``) gives it a fake one, in which
this process is rank 0 and every collective returns at once.  Nothing
else starts a fake group.

``MeshShape`` is a mesh's axis names and sizes without ranks, for the
placement maps of meshes larger than the host (``launch/shardings.py``
reads a ``DeviceMesh`` and a ``MeshShape`` alike).
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, e.g. ``MeshShape((16, 16),
    ("data", "model"))``; ``shape`` maps each name to its size, as a
    ``jax.sharding.Mesh``'s does."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def ensure_default_group(device: DeviceLike = None) -> None:
    """The default process group when none exists, gloo for CPU tensors
    and, with CUDA present, NCCL for CUDA tensors: from the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) where a
    launcher set ``WORLD_SIZE`` above 1, else one rank over a
    ``HashStore``.  For CUDA work in a group of more than one rank, this
    rank's card becomes the current device (``bind_card``)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    if dev.type == "cuda" and dist.get_world_size() > 1:
        bind_card()


def bind_card() -> int:
    """Make this rank's card the current CUDA device and return its
    index: ``LOCAL_RANK`` where a launcher set it, else the rank modulo
    the host's cards."""
    cards = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % cards))
    if local >= cards:
        raise ValueError(f"local rank {local} on a host with {cards} cards")
    torch.cuda.set_device(local)
    return local


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: DeviceLike = None) -> DeviceMesh:
    """Mesh over ranks ``0 .. prod(shape) - 1`` of the default group
    (made with one rank if there is none), for tensors on ``device``'s
    type (``None`` = CUDA).  Collective: every rank of the default group
    calls it."""
    dev = resolve_device(device)
    ensure_default_group(dev)
    n = math.prod(shape)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the default "
                         f"group has {world}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks.  Over ranks 0 .. 255 or 511 of the
    default group; raises without a group of that many.  For ``meta``
    tensors, which the dry run traces on."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; "
                         f"the default group has {world}")
    return DeviceMesh("meta", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes used for data parallelism (everything except 'model')."""
    return tuple(a for a in axis_sizes(mesh) if a != "model")


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def in_mesh(mesh: DeviceMesh) -> bool:
    return mesh.get_coordinate() is not None


# ------------------------------------------------------------ local launch
def _rank_main(rank: int, fn: Callable, n: int, store_path: str,
               backend: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    try:
        fn(rank, n, *args)
    finally:
        dist.destroy_process_group()


def spawn_local(fn: Callable, n: int, *args, timeout: float = 120.0,
                backend: str = "gloo") -> None:
    """Run ``fn(rank, n, *args)`` on ``n`` local processes joined in one
    group (a ``FileStore`` in a fresh temporary directory): gloo, or
    ``"cpu:gloo,cuda:nccl"`` for ranks that work on their own cards.
    ``fn`` must be importable from a module that a spawned child can
    import (the port package, or a helper beside the tests that imports
    no JAX; not a test module).  Raises if a rank
    raises, or kills every rank and raises ``TimeoutError`` after
    ``timeout`` seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, n, os.path.join(tmp, "store"), backend, args),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{getattr(fn, '__name__', fn)} on {n} "
                                   f"ranks did not end in {timeout} s")

