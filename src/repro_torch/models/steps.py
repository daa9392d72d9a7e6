"""Step factories of the port, twin of ``repro.models.steps``: train,
prefill and decode, with or without a mesh.

Without a mesh (``mesh_info=None``) the MoE layers run ``moe_dense``;
on a mesh they run ``moe_ep``, as the reference's steps run its
``shard_map`` MoE.  On a mesh the steps take the state, the parameters,
the batch and the cache as DTensors placed by the spec trees
(``launch.shardings.distribute`` of ``train_state_specs``,
``param_specs``, ``batch_specs``, ``cache_specs_tree``): the
counterpart of ``jax.jit(..., in_shardings=...)``.  DTensor's sharding
propagation then inserts what GSPMD inserts: the FSDP all-gathers of the
parameters cut over "data" and their reduce-scatters in the backward,
the TP reductions over "model", and the reductions of the loss and of
the global grad norm over every rank; ``moe_ep`` and the SSM layers run
on each rank's blocks through ``local_map``.  The loss is the global
batch's mean.  Each gradient is placed as its parameter before AdamW,
which updates every rank's blocks in place.  The reference pins the
residual stream to batch-over-dp with a sharding constraint (its
``make_shard_act``); the port's model does the same on DTensors
(``layers.pin_batch``, at each layer's end and each sublayer's output,
in the forward and the backward).

Plain tensors on a mesh are a one-rank mesh's whole state (the steps
then run the plain operations, ``moe_ep`` included); a mesh of more
ranks needs DTensors.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import shardings as sh
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
    require grad; no ``.grad`` is kept.  On DTensors each gradient comes
    back placed as its parameter."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with implicit_replication():      # positions, masks beside DTensors
        loss = M.loss_fn(params, cfg, batch, moe_fn)
        grads = torch.autograd.grad(loss, leaves)
        grads = tuple(g.redistribute(p.device_mesh, p.placements)
                      if isinstance(p, DTensor) else g
                      for p, g in zip(leaves, grads))
    return loss.detach(), grads


def _check_placed(mesh_info: Optional[M.MeshInfo], tree) -> None:
    if mesh_info is None or math.prod(mesh_info.mesh.shape) == 1:
        return
    if not isinstance(tree_leaves(tree)[0], DTensor):
        raise ValueError(f"a step over a {tuple(mesh_info.mesh.shape)} "
                         "mesh takes DTensors: place the tree with "
                         "launch.shardings.distribute")


def make_train_step(cfg: ArchConfig, opt: AdamWConfig,
                    mesh_info: Optional[M.MeshInfo] = None) -> Callable:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``: the loss
    and every parameter's gradient (the parameters are leaf tensors that
    require grad), then ``adamw_update`` in place.  The gradients are
    dropped after the update.  ``batch`` holds ``tokens`` (B, S) int32
    and a frontend's embeddings, on the parameters' device (DTensors
    placed by ``batch_specs`` on a mesh).  The loss and the grad norm come
    back as plain 0-d tensors, the same on every rank."""
    moe_fn = make_moe_fn(mesh_info)

    def train_step(state, batch):
        _check_placed(mesh_info, state["params"])
        loss, grads = loss_and_grads(state["params"], cfg, batch, moe_fn)
        grads = iter(grads)
        state, gnorm = adamw_update(state, tree_map(lambda _: next(grads),
                                                    state["params"]), opt)
        return state, {"loss": sh.full(loss), "grad_norm": sh.full(gnorm)}

    return train_step


def make_prefill_step(cfg: ArchConfig, max_len: int,
                      mesh_info: Optional[M.MeshInfo] = None) -> Callable:
    moe_fn = make_moe_fn(mesh_info)

    def prefill_step(params, batch):
        _check_placed(mesh_info, params)
        with implicit_replication():
            return M.prefill(params, cfg, batch, max_len=max_len,
                             moe_fn=moe_fn)

    return prefill_step


def make_decode_step(cfg: ArchConfig,
                     mesh_info: Optional[M.MeshInfo] = None) -> Callable:
    moe_fn = make_moe_fn(mesh_info)

    def decode_step(params, cache, tokens, pos):
        _check_placed(mesh_info, params)
        with implicit_replication():
            return M.decode_step(params, cfg, cache, tokens, pos,
                                 moe_fn=moe_fn)

    return decode_step
