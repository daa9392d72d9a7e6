"""Step factories of the port, twin of ``repro.models.steps``: train,
prefill and decode, with or without a mesh.

Without a mesh (``mesh_info=None``) the MoE layers run ``moe_dense``;
on a mesh they run ``moe_ep`` on this rank's batch block and experts,
as the reference's steps run its ``shard_map`` MoE.  The reference
also pins the residual stream to batch-over-dp with a sharding
constraint (its ``make_shard_act``); here each rank already holds its
own batch block, so that has no counterpart.  A train step on a mesh is
data-parallel with replicated parameters and AdamW state: each
rank takes the gradient of its own block's loss, the gradients are
averaged over the dp group, and every replica applies the same update.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map


def make_moe_fn(mesh_info: Optional[M.MeshInfo]):
    """``moe_dense`` without a mesh; the expert-parallel ``moe_ep`` on
    one."""
    if mesh_info is None:
        return L.moe_dense
    return functools.partial(L.moe_ep, mesh=mesh_info.mesh,
                             ep_axis=mesh_info.ep_axis)


def loss_and_grads(params, cfg: ArchConfig, batch, moe_fn=L.moe_dense
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The loss (detached) and every parameter leaf's gradient, in
    ``tree_leaves``' order.  The parameters become leaf tensors that
    require grad; no ``.grad`` is kept."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = M.loss_fn(params, cfg, batch, moe_fn)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _mean_over(group, n: int, tensors) -> None:
    """Each tensor replaced in place by its mean over ``group`` (``n``
    ranks): a sum, then a division (gloo has no average)."""
    for t in tensors:
        dist.all_reduce(t, group=group)
        if n > 1:
            t.div_(n)


def make_train_step(cfg: ArchConfig, opt: AdamWConfig,
                    mesh_info: Optional[M.MeshInfo] = None) -> Callable:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``: the loss
    and every parameter's gradient (the parameters are leaf tensors that
    require grad), then ``adamw_update`` in place.  The gradients are
    dropped after the update.  ``batch`` holds ``tokens`` (B, S) int32
    and a frontend's embeddings, on the parameters' device: on a mesh,
    this rank's block of the global batch.  There the gradients and the
    loss are averaged over the dp group before the update, so the
    replicas stay equal and the loss is the global batch's.  The state
    is replicated, so the ep axis must be of size 1 (the global grad norm
    would otherwise need the other ranks' experts), and there is one dp
    axis (the trainer's "data")."""
    moe_fn = make_moe_fn(mesh_info)
    dp = None
    if mesh_info is not None:
        sizes = mesh_lib.axis_sizes(mesh_info.mesh)
        if sizes[mesh_info.ep_axis] != 1:
            raise ValueError(
                f"a train step over an ep axis of {sizes[mesh_info.ep_axis]}"
                " needs sharded AdamW state; the port's is replicated")
        if len(mesh_info.dp_axes) != 1:
            raise ValueError(f"one data-parallel axis, not "
                             f"{mesh_info.dp_axes}")
        axis, = mesh_info.dp_axes
        dp = (mesh_info.mesh.get_group(axis), sizes[axis])

    def train_step(state, batch):
        loss, grads = loss_and_grads(state["params"], cfg, batch, moe_fn)
        if dp is not None:
            loss = loss.clone()
            _mean_over(*dp, (loss,) + grads)
        grads = iter(grads)
        state, gnorm = adamw_update(state, tree_map(lambda _: next(grads),
                                                    state["params"]), opt)
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig, max_len: int,
                      mesh_info: Optional[M.MeshInfo] = None) -> Callable:
    moe_fn = make_moe_fn(mesh_info)

    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, max_len=max_len, moe_fn=moe_fn)

    return prefill_step


def make_decode_step(cfg: ArchConfig,
                     mesh_info: Optional[M.MeshInfo] = None) -> Callable:
    moe_fn = make_moe_fn(mesh_info)

    def decode_step(params, cache, tokens, pos):
        return M.decode_step(params, cfg, cache, tokens, pos, moe_fn=moe_fn)

    return decode_step
