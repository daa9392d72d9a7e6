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
  latest step, with digests of the rank's train state (gathered whole
  and its own blocks) after each step it takes and at each resize, and
  rank 0's parameters after the run.
* ``market_rank``: ``launch.train.market_scenario`` on up to ``n``
  devices.
* ``sharded_train_rank``: ``make_train_step`` over a mesh of every rank
  with the state as DTensors placed by ``train_state_specs``, from a
  step-0 checkpoint, with each step's loss and grad norm and the
  parameters after the last step.
* ``sharded_serve_rank``: ``make_prefill_step`` and two
  ``make_decode_step`` steps over a mesh of every rank on DTensors
  placed by ``param_specs``, ``batch_specs`` and ``cache_specs_tree``,
  beside the same steps on plain tensors (``moe_dense``).
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import shardings as sh
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch.mesh import dp_axes, make_mesh
from repro_torch.launch.train import market_scenario
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import steps as S
from repro_torch.optim import AdamWConfig, abstract_train_state
from repro_torch.train.trainer import ScheduledBroker, TrainConfig, Trainer
from repro_torch.tree import tree_leaves, tree_map, walk


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


def _digest(tree) -> str:
    """sha256 of every leaf's bytes in ``tree_leaves`` order."""
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _blocks(state):
    """This rank's local block of every DTensor leaf of ``state``."""
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                    state)


def trainer_rank(rank: int, n: int, cfg: ArchConfig, dcfg: DataConfig,
                 opt: AdamWConfig, schedule: Dict[int, int], steps: int,
                 ckpt_dir: str, out_dir: str, device: str = "cpu") -> None:
    """Outputs: ``losses``, ``resizes``, ``restores``, the ``card`` the
    rank ran on (-1 on the CPU) and, for each step this rank took,
    ``digest_steps`` and the sha256 of its train state after it:
    ``digests`` of the state gathered whole, ``local_digests`` of the
    rank's own blocks, ``shard_digests`` of ``local_shards`` of the
    gathered state under the Trainer's placement (the reference's
    ``NamedSharding`` block).  At each resize that gives the rank a
    state: ``resize_in``, the digest of the whole state it received
    from rank 0, and ``resize_blocks`` / ``resize_shards``, those of its
    blocks after ``distribute`` onto the new mesh and of ``local_shards``
    of the received state.  On rank 0, the train state after the run,
    keyed ``s`` + ``walk``'s keys."""
    tr = Trainer(cfg, dcfg, opt, TrainConfig(steps=steps, checkpoint_every=8,
                                             checkpoint_dir=ckpt_dir),
                 ScheduledBroker(schedule, 1), device=device)
    taken, digests, local_d, shard_d = [], [], [], []
    resize_in, resize_blocks, resize_shards = [], [], []
    step, build = tr._step, tr._build

    def recorded(state, batch):
        out = step(state, batch)
        taken.append(int(out[0]["step"]) - 1)
        whole = sh.full(out[0])
        digests.append(_digest(whole))
        local_d.append(_digest(_blocks(out[0])))
        shard_d.append(_digest(sh.local_shards(whole, tr._place, tr.mesh)))
        return out

    def rebuilt(n_devices, state):
        build(n_devices, state)
        if state is not None and tr.state is not None:
            resize_in.append(_digest(state))
            resize_blocks.append(_digest(_blocks(tr.state)))
            resize_shards.append(_digest(sh.local_shards(state, tr._place,
                                                         tr.mesh)))
    tr._step, tr._build = recorded, rebuilt
    rep = tr.run(resume=True)
    card = torch.cuda.current_device() if tr.device.type == "cuda" else -1
    final = {f"s{key}": leaf.detach().cpu().numpy() for key, _, leaf in
             walk(tr.state)} if rank == 0 else {}
    _save(out_dir, rank, losses=np.asarray(rep.losses),
          resizes=np.asarray(rep.resizes, np.int64).reshape(-1, 3),
          restores=rep.restores, digest_steps=np.asarray(taken, np.int64),
          digests=np.asarray(digests), local_digests=np.asarray(local_d),
          shard_digests=np.asarray(shard_d), resize_in=np.asarray(resize_in),
          resize_blocks=np.asarray(resize_blocks),
          resize_shards=np.asarray(resize_shards), card=card, **final)


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


def sharded_train_rank(rank: int, n: int, cfg: ArchConfig, dcfg: DataConfig,
                       opt: AdamWConfig, shape: Tuple[int, ...],
                       axes: Tuple[str, ...], steps: int, ckpt_dir: str,
                       out_dir: str) -> None:
    """Outputs: ``losses`` and ``grad_norms`` of each step (every rank),
    ``blocks``: the keys of the state and first-batch leaves whose local
    block under ``distribute`` differs from ``local_shard``'s (every
    rank), and on rank 0 the first step's gradients and the parameters
    after the last step, gathered and keyed by ``walk``'s keys (``g...``,
    ``p...``)."""
    mesh = make_mesh(shape, axes, "cpu")
    mi = M.MeshInfo(mesh, dp_axes(mesh), "model")
    whole = CheckpointManager(ckpt_dir).restore(
        0, abstract_train_state(M.abstract_params(cfg), opt), "cpu")
    sspec = sh.train_state_specs(cfg, mesh)
    state = sh.distribute(whole, sspec, mesh)
    bspec = sh.batch_specs(cfg, mesh, dcfg.global_batch)
    batch0 = {k: torch.from_numpy(v) for k, v in
              SyntheticTokens(dcfg).batch(0).items()}
    blocks = [key for (key, _, a), (_, _, b) in zip(
        walk([state, sh.distribute(batch0, bspec, mesh)]),
        walk([sh.local_shards(whole, sspec, mesh),
              sh.local_shards(batch0, bspec, mesh)]))
        if not torch.equal(a.to_local(), b)]
    data = SyntheticTokens(dcfg)
    step = S.make_train_step(cfg, opt, mi)
    losses, norms, out = [], [], {}
    for i in range(steps):
        batch = sh.distribute({k: torch.from_numpy(v) for k, v in
                               data.batch(i).items()}, bspec, mesh)
        if i == 0:
            _, grads = S.loss_and_grads(state["params"], cfg, batch,
                                        S.make_moe_fn(mi))
            out = {f"g{key}": sh.full(g).numpy() for (key, _, _), g in
                   zip(walk(state["params"]), grads)}
            del grads
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    for key, _, leaf in walk(sh.full(state["params"])):
        out[f"p{key}"] = leaf.detach().numpy()
    _save(out_dir, rank, losses=np.asarray(losses),
          grad_norms=np.asarray(norms), blocks=np.asarray(blocks, str),
          **(out if rank == 0 else {}))


def sharded_serve_rank(rank: int, n: int, archs, shape: Tuple[int, ...],
                       axes: Tuple[str, ...], out_dir: str) -> None:
    """Outputs, per arch: ``<arch>/logits`` (the prefill's last logits,
    then each decode step's) on DTensors, gathered, and ``<arch>/plain``,
    the plain steps' on this rank's whole copy; 4 prompts of 16 seeded
    tokens, a 24-deep cache."""
    from repro_torch.configs import get_config
    mesh = make_mesh(shape, axes, "cpu")
    mi = M.MeshInfo(mesh, dp_axes(mesh), "model")
    B, T, max_len = 4, 16, 24
    out = {}
    for arch in archs:
        cfg = get_config(arch).reduced()
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab_size, (B, T), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        logits, cache = M.prefill(params, cfg, {"tokens": toks},
                                  max_len=max_len)
        placed = sh.distribute(params, sh.param_specs(cfg, mesh), mesh)
        dlog, dcache = S.make_prefill_step(cfg, max_len, mi)(
            placed, sh.distribute({"tokens": toks},
                                  sh.batch_specs(cfg, mesh, B), mesh))
        dcache = sh.distribute(dcache, sh.cache_specs_tree(cfg, mesh, B),
                               mesh)
        got, want = [sh.full(dlog)], [logits]
        for pos in (T, T + 1):
            tok = want[-1][:, -1].argmax(-1).to(torch.int32)[:, None]
            logits, cache = M.decode_step(params, cfg, cache, tok, pos)
            dlog, dcache = S.make_decode_step(cfg, mi)(
                placed, dcache, sh.distribute(tok, sh.P(dp_axes(mesh), None),
                                              mesh), pos)
            got.append(sh.full(dlog))
            want.append(logits)
        out[f"{arch}/logits"] = torch.cat(got, 1).numpy()
        out[f"{arch}/plain"] = torch.cat(want, 1).numpy()
    _save(out_dir, rank, **out)
