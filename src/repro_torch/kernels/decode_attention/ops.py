"""Decode attention as the model calls it: the CUDA kernel on CUDA
tensors, the plain version on CPU and ``meta`` tensors (on ``meta`` it
gives the shapes and dtypes only: the dry run traces it there), an
error on any other device.  ``pos`` is a host integer (a tensor costs
one device read).

On DTensors (a decode step over a mesh) on CUDA and on the CPU the
attention runs on each rank's blocks through ``local_map``, q placed as
the cache without its sequence dim (its batch as the cache's batch, its
kv heads as the cache's heads, whole over the mesh dims that cut the
sequence).  Where no mesh dimension of more than one rank cuts the
cache's sequence, each rank runs the whole-cache kernel (the plain
version on the CPU).  Where some do, each rank takes the partial
softmax of its block (``partial``: the kernel's partial mode, or the
plain partial on the CPU), all-gathers its ``(o, m, l)`` over those mesh
dims and merges them (``ref.merge_partials``); the result is replicated
over them.  On ``meta`` the plain version runs under DTensor's sharding
propagation, as the dry run counts it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref as R


# torch 2.13 renames the collective; older releases have only the old name
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _local(q, k, v, pos: int, window: int):
    dev = q.device
    if dev.type == "cuda":
        return K.decode_attention_cuda(q.contiguous(), k, v, pos, window)
    if dev.type in ("cpu", "meta"):
        return R.decode_attention_ref(q, k, v, pos, window)
    raise ValueError(f"no decode attention for device {dev}")


def partial(q, k, v, pos: int, window: int, offset: int):
    """The float32 ``(o, m, l)`` of one block of the cache whose first
    position is global position ``offset``: the kernel's partial mode on
    CUDA, the plain partial on the CPU."""
    dev = q.device
    if dev.type == "cuda":
        return K.decode_attention_partial_cuda(q.contiguous(), k, v, pos,
                                               window, offset)
    if dev.type == "cpu":
        return R.decode_attention_partial_ref(q, k, v, pos, window, offset)
    raise ValueError(f"no partial decode attention for device {dev}")


def gather_partials(o, m, l, groups):
    """Every rank's ``(o, m, l)`` over ``groups`` (the process groups of
    the mesh dims that cut the sequence), stacked on a leading rank dim:
    the three packed into one float32 tensor, one all-gather a group."""
    packed = torch.cat([o, m[..., None], l[..., None]], dim=-1).contiguous()
    for group in groups:
        n = dist.get_world_size(group)
        out = packed.new_empty((n * packed.shape[0],) + packed.shape[1:])
        _all_gather(out, packed, group=group)     # ranks along dim 0
        packed = out.view((n,) + tuple(packed.shape))
    packed = packed.reshape((-1,) + tuple(o.shape[:-1]) + (o.shape[-1] + 2,))
    hd = o.shape[-1]
    return packed[..., :hd], packed[..., hd], packed[..., hd + 1]


def _on_blocks(q, k, v, pos: int, window: int):
    """The attention on each rank's blocks: q placed as the cache without
    its sequence dim; a cut sequence's partials merged across ranks."""
    mesh = k.device_mesh
    cuts = [i for i, pl in enumerate(k.placements)
            if isinstance(pl, Shard) and pl.dim == 1 and mesh.size(i) > 1]
    qp = tuple(Shard(0) if pl == Shard(0) else
               Shard(1) if pl == Shard(2) else Replicate()
               for pl in k.placements)
    if cuts:
        _, offset = compute_local_shape_and_global_offset(
            k.shape, mesh, k.placements)
        groups = [mesh.get_group(i) for i in cuts]

        def fn(ql, kl, vl, pos, window):
            o, m, l = partial(ql, kl, vl, pos, window, offset[1])
            return R.merge_partials(*gather_partials(o, m, l, groups),
                                    dtype=ql.dtype)
    else:
        fn = _local
    return local_map(fn, out_placements=(qp,),
                     in_placements=(qp, k.placements, v.placements, None,
                                    None),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, pos, window)


def decode_attention(q, k, v, pos, window: int = 0):
    """q (B, K, G, hd); k/v (B, S, K, hd) -> (B, K, G, hd)."""
    pos = int(pos)
    if isinstance(k, DTensor) and k.device.type in ("cuda", "cpu"):
        return _on_blocks(q, k, v, pos, window)
    return _local(q, k, v, pos, window)
