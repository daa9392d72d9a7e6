"""AdamW with decoupled weight decay, global-norm clipping and a
configurable state dtype, the twin of ``repro.optim.adamw``.

The state is the reference's ``{"params", "m", "v", "step"}`` with
``step`` a 0-d int32 tensor, and ``adamw_update`` takes the reference's
steps: the global norm first (a float32 sum of squares per leaf, then
their sum, then the square root), then every leaf.  It updates the state
IN PLACE, leaf by leaf, and a stacked leaf (``tree.walk``'s ``stacked``:
under ``params["blocks"]`` or ``params["enc_blocks"]``) row by row: at
full width OLMoE's stacked expert matrices hold 2.15 G elements each,
and a float32 temporary of a whole leaf (8.6 GB; the update makes about
five) would not fit beside the state, where one row's is 0.54 GB.

The float32 arithmetic follows the reference's jitted graph on XLA's CPU
backend: Python constants become float32 constants (``1 - b1`` is
float32 0.1), the warm-up's division by a constant is a product with the
constant's float32 reciprocal, and XLA folds ``(m / bc1) / (sqrt(v̂) +
eps)`` into one division ``m / (bc1 * (sqrt(v̂) + eps))``.  XLA also
contracts some of the products into fused multiply-adds, which eager
PyTorch does not; ``tests/test_torch_train.py`` holds each output
elementwise to the reference and reports the largest ulp gap.

On DTensor leaves (a state placed by ``launch.shardings.distribute``,
each gradient placed as its parameter) a leaf's sum of squares is a
partial sum over the mesh dims that cut it; DTensor reduces the partial
sums over every rank when the square root needs the whole, so the
global norm is the whole gradient's.  Then every rank updates its own
blocks (p, g, m and v are placed alike) as plain local tensors, row by
row as above (the stacked dim is never cut): the update is elementwise
and needs nothing of the other ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.device import recip32
from repro_torch.tree import tree_leaves, tree_map, walk


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100


TrainState = Dict[str, Any]   # {"params", "m", "v", "step"}


# ------------------------------------------------------------------ state
def adamw_init(params, state_dtype: str = "float32") -> Tuple[Any, Any]:
    dt = getattr(torch, state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return tree_map(zeros, params), tree_map(zeros, params)


def make_train_state(params, opt: AdamWConfig) -> TrainState:
    m, v = adamw_init(params, opt.state_dtype)
    dev = tree_leaves(params)[0].device
    return {"params": params, "m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_train_state(params_abstract, opt: AdamWConfig) -> TrainState:
    """``make_train_state``'s tree with shapes and dtypes but no storage
    (every leaf on the ``meta`` device): the template that
    ``CheckpointManager.restore`` fills."""
    return make_train_state(tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        params_abstract), opt)


# ----------------------------------------------------------------- update
def _schedule(opt: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() * recip32(max(opt.warmup_steps, 1)),
                       max=1.0)
    return opt.lr * warm


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (a view: in-place writes reach it), else
    ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _rows(leaf: torch.Tensor, stacked: bool):
    return leaf.unbind(0) if stacked else (leaf,)


def _sum_squares(g: torch.Tensor, stacked: bool) -> torch.Tensor:
    """float32 sum of ``g``'s squares, a stacked leaf one row at a
    time."""
    total = None
    for row in _rows(g, stacked):
        s = torch.sum(row.float() ** 2)
        total = s if total is None else total + s
    return total


def _update(p, g, m, v, scale, lr, bc1, bc2, opt: AdamWConfig) -> None:
    """The reference's ``upd`` on one leaf or row, written into p, m and
    v.  The temporaries are made once and then reused in place."""
    g32 = g.float() * scale
    m32 = m.float() * opt.b1
    m32.add_(g32 * (1 - opt.b1))
    v32 = v.float() * opt.b2
    t = g32 * (1 - opt.b2)
    v32.add_(t.mul_(g32))
    den = torch.sqrt(v32 / bc2)
    den.add_(opt.eps).mul_(bc1)          # XLA: (m/bc1)/(√v̂+eps) -> m/(bc1(√v̂+eps))
    step_ = torch.div(m32, den, out=den)
    pf = p.float()
    t = pf * opt.weight_decay
    t.add_(step_).mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(t)
    else:
        p.copy_(pf.sub_(t))
    m.copy_(m32)
    v.copy_(v32)


@torch.no_grad()
def adamw_update(state: TrainState, grads, opt: AdamWConfig):
    """One AdamW step.  Writes the new params, m and v into the state's
    tensors and returns ``({"params", "m", "v", "step": step + 1},
    global grad norm)``."""
    with implicit_replication():      # the constants beside DTensors
        return _adamw_update(state, grads, opt)


def _adamw_update(state: TrainState, grads, opt: AdamWConfig):
    step = state["step"] + 1
    flat = list(zip(walk(state["params"]), tree_leaves(grads),
                    tree_leaves(state["m"]), tree_leaves(state["v"])))
    sq = None
    for (_, stacked, _), g, _, _ in flat:
        s = _sum_squares(g, stacked)
        sq = s if sq is None else sq + s
    gnorm = torch.sqrt(sq)
    clip = torch.tensor(opt.clip_norm, dtype=torch.float32,
                        device=gnorm.device)
    scale = _local(torch.clamp(clip / (gnorm + 1e-9), max=1.0))
    lr = _local(_schedule(opt, step))
    t = _local(step).float()
    bc1 = 1.0 - torch.pow(torch.tensor(opt.b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(opt.b2, dtype=torch.float32,
                                       device=t.device), t)
    for (_, stacked, p), g, m, v in flat:
        for rows in zip(*(_rows(_local(a), stacked) for a in (p, g, m, v))):
            _update(*rows, scale, lr, bc1, bc2, opt)
    return {"params": state["params"], "m": state["m"], "v": state["v"],
            "step": step}, gnorm
