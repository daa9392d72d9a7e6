"""The train step of the port, twin of ``repro.models.steps``'s
``make_train_step`` on one device (the dense MoE, ``layers.moe_dense``).
Serving runs ``model.prefill`` / ``model.decode_step`` directly
(``serve/server.py``)."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map


def loss_and_grads(params, cfg: ArchConfig,
                   batch) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The loss (detached) and every parameter leaf's gradient, in
    ``tree_leaves``' order.  The parameters become leaf tensors that
    require grad; no ``.grad`` is kept."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = M.loss_fn(params, cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def make_train_step(cfg: ArchConfig, opt: AdamWConfig,
                    mesh_info=None) -> Callable:
    """``step(state, batch) -> (state, {"loss", "grad_norm"})``: the loss
    and every parameter's gradient (the parameters are leaf tensors that
    require grad), then ``adamw_update`` in place.  The gradients are
    dropped after the update.  ``batch`` holds ``tokens`` (B, S) int32
    and a frontend's embeddings, on the parameters' device."""
    if mesh_info is not None:
        raise NotImplementedError(
            "a train step over a mesh (the expert-parallel MoE and "
            "launch/) is not ported yet: ROADMAP Queue 1 item 4")

    def train_step(state, batch):
        loss, grads = loss_and_grads(state["params"], cfg, batch)
        grads = iter(grads)
        state, gnorm = adamw_update(state, tree_map(lambda _: next(grads),
                                                    state["params"]), opt)
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step
