"""Decode attention as the model calls it: the CUDA kernel on CUDA
tensors, the plain version on CPU and ``meta`` tensors (on ``meta`` it
gives the shapes and dtypes only: the dry run traces it there), an
error on any other device.  ``pos`` is a host integer (a tensor costs
one device read).

On DTensors (a decode step over a mesh) the plain version runs under
DTensor's sharding propagation on the CPU and on ``meta``.  On CUDA the
kernel runs on each rank's blocks through ``local_map`` when no mesh
dimension of more than one rank cuts the cache's sequence; a cut
sequence needs a cross-rank merge of the partial softmaxes, which the
port does not have, and raises ``NotImplementedError``.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.decode_attention import kernel as K
from repro_torch.kernels.decode_attention import ref as R


def _local(q, k, v, pos: int, window: int):
    dev = q.device
    if dev.type == "cuda":
        return K.decode_attention_cuda(q.contiguous(), k, v, pos, window)
    if dev.type in ("cpu", "meta"):
        return R.decode_attention_ref(q, k, v, pos, window)
    raise ValueError(f"no decode attention for device {dev}")


def _on_blocks(q, k, v, pos: int, window: int):
    """The kernel on each rank's blocks: q placed as the cache is placed
    (its batch dim as the cache's, its kv heads as the cache's heads)."""
    mesh = k.device_mesh
    qp = []
    for i, pl in enumerate(k.placements):
        if isinstance(pl, Shard) and pl.dim == 1 and mesh.size(i) > 1:
            raise NotImplementedError(
                "decode attention over a cache whose sequence is cut over "
                f"{mesh.size(i)} ranks needs a cross-rank log-sum-exp merge "
                "of the per-shard partial softmaxes; the port has none")
        qp.append(Shard(0) if pl == Shard(0) else
                  Shard(1) if pl == Shard(2) else Replicate())
    qp = tuple(qp)
    return local_map(_local, out_placements=(qp,),
                     in_placements=(qp, k.placements, v.placements, None,
                                    None),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, pos, window)


def decode_attention(q, k, v, pos, window: int = 0):
    """q (B, K, G, hd); k/v (B, S, K, hd) -> (B, K, G, hd)."""
    pos = int(pos)
    if isinstance(k, DTensor) and k.device.type == "cuda":
        return _on_blocks(q, k, v, pos, window)
    return _local(q, k, v, pos, window)
