"""SPMD functions that ``mesh.spawn_local`` runs on local ranks.

Each reads its inputs from an npz (or its arguments) and writes this
rank's outputs to ``out_dir/rank<r>.npz``, so a caller that imports JAX
can hold them to the reference while the ranks import only the port.

* ``moe_ep_rank``: one MoE layer's ``moe_ep`` on a (data, model) mesh,
  with this rank's batch block and experts, forward and backward, and
  the dispatch it recorded (``buf_tok`` and the per-expert pair
  counts).
* ``trainer_rank``: the ``Trainer`` under a ``ScheduledBroker`` on the
  CPU or on the rank's card, resumed from the checkpoint directory's
  latest step, with a digest of the rank's train state after each step
  it takes.
* ``market_rank``: ``launch.train.market_scenario`` on up to ``n``
  devices.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import dp_axes, make_mesh
from repro_torch.launch.train import market_scenario
from repro_torch.models import layers as L
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import ScheduledBroker, TrainConfig, Trainer
from repro_torch.tree import tree_leaves


def _save(out_dir: str, rank: int, **arrays) -> None:
    """``out_dir/rank<r>.npz``, written to a temporary name and renamed,
    so a reader never sees a partial file."""
    path = os.path.join(out_dir, f"rank{rank}.npz")
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def moe_ep_rank(rank: int, n: int, cfg: ArchConfig, shape: Tuple[int, int],
                in_path: str, out_dir: str) -> None:
    """Inputs: ``router``, ``wg``, ``wu``, ``wd`` (all experts), ``x``
    and ``up`` (the whole batch, (B, S, D)).  The loss is ``sum(y *
    up)`` over this rank's block.  Outputs: ``y`` and ``gx`` (this
    rank's block), the gradients of the router and of this rank's
    experts summed over the dp group (the whole batch's), ``buf_tok``,
    ``counts`` and the rank's mesh ``coord``."""
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    with np.load(in_path) as z:
        full = {k: torch.from_numpy(z[k]) for k in z.files}
    dp = dp_axes(mesh)
    p = sh.local_shards({k: full[k] for k in ("router", "wg", "wu", "wd")},
                        sh.replicated_over(sh.moe_specs(cfg), dp), mesh)
    x, up = (sh.local_shard(full[k], sh.P(dp, None, None), mesh)
             for k in ("x", "up"))
    for t in (*p.values(), x):
        t.requires_grad_(True)
    L.DISPATCH = []
    y = L.moe_ep(p, cfg, x, mesh=mesh, ep_axis="model")
    (buf_tok, counts, _, _, _), = L.DISPATCH
    L.DISPATCH = None
    (y * up).sum().backward()
    grads = {f"g_{k}": t.grad for k, t in p.items()}
    for g in grads.values():
        dist.all_reduce(g, group=mesh.get_group("data"))
    _save(out_dir, rank, y=y.detach().numpy(), gx=x.grad.numpy(),
          buf_tok=buf_tok.numpy(), counts=counts.numpy(),
          coord=np.asarray(mesh.get_coordinate()),
          **{k: g.numpy() for k, g in grads.items()})


def _digest(state) -> str:
    h = hashlib.sha256()
    for leaf in tree_leaves(state):
        h.update(leaf.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def trainer_rank(rank: int, n: int, cfg: ArchConfig, dcfg: DataConfig,
                 opt: AdamWConfig, schedule: Dict[int, int], steps: int,
                 ckpt_dir: str, out_dir: str, device: str = "cpu") -> None:
    """Outputs: ``losses``, ``resizes``, ``restores`` and, for each step
    this rank took, ``digest_steps`` and the sha256 ``digests`` of its
    train state after it, and the ``card`` the rank ran on (-1 on the
    CPU)."""
    tr = Trainer(cfg, dcfg, opt, TrainConfig(steps=steps, checkpoint_every=8,
                                             checkpoint_dir=ckpt_dir),
                 ScheduledBroker(schedule, 1), device=device)
    taken, digests = [], []
    step = tr._step

    def recorded(state, batch):
        out = step(state, batch)
        taken.append(int(out[0]["step"]) - 1)
        digests.append(_digest(out[0]))
        return out
    tr._step = recorded
    rep = tr.run(resume=True)
    card = torch.cuda.current_device() if tr.device.type == "cuda" else -1
    _save(out_dir, rank, losses=np.asarray(rep.losses),
          resizes=np.asarray(rep.resizes, np.int64).reshape(-1, 3),
          restores=rep.restores, digest_steps=np.asarray(taken, np.int64),
          digests=np.asarray(digests), card=card)


def market_rank(rank: int, n: int, cfg: ArchConfig, dcfg: DataConfig,
                opt: AdamWConfig, ckpt_dir: str, out_dir: str) -> None:
    """Outputs: each of the three runs' ``losses{i}``, ``steps{i}``,
    ``restores{i}`` and ``resizes{i}``, and trainA's ``bill``."""
    reps, bills = market_scenario(cfg, dcfg, opt, ckpt_dir, n, "cpu")
    out = {"bill": bills.get("trainA", 0.0)}
    for i, r in enumerate(reps):
        out[f"losses{i}"] = np.asarray(r.losses)
        out[f"steps{i}"] = r.steps_done
        out[f"restores{i}"] = r.restores
        out[f"resizes{i}"] = np.asarray(r.resizes, np.int64).reshape(-1, 3)
    _save(out_dir, rank, **out)
