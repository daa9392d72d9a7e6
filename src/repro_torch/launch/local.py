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
* ``sharded_decode_rank``: ``make_prefill_step`` and teacher-forced
  ``make_decode_step`` steps over a mesh of every rank on DTensors
  placed by ``param_specs``, ``batch_specs`` and ``cache_specs_tree``,
  from given parameters, prompt and decode tokens and positions
  (``decode_inputs`` writes them), on the CPU or on the rank's card,
  with the decode kernel's launches.
* ``sharded_serve_full_rank``: ``serve_full``, a model too large for
  one card at its published widths on the ranks' cards: each rank draws
  its own blocks (``model.init_blocks``), then a prefill and decode
  steps over the mesh, timed, with peak memory, launches and
  ``moe_ep``'s dropped pairs.
"""
from __future__ import annotations

import hashlib
import os
import time
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
from repro_torch.kernels import build
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


def _device(device: str) -> torch.device:
    """The rank's device after ``make_mesh``: its own card (bound by the
    mesh's ``bind_card``) for ``"cuda"``."""
    return torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def sharded_train_rank(rank: int, n: int, cfg: ArchConfig, dcfg: DataConfig,
                       opt: AdamWConfig, shape: Tuple[int, ...],
                       axes: Tuple[str, ...], steps: int, ckpt_dir: str,
                       out_dir: str, device: str = "cpu") -> None:
    """Outputs: ``losses`` and ``grad_norms`` of each step (every rank),
    ``blocks``: the keys of the state and first-batch leaves whose local
    block under ``distribute`` differs from ``local_shard``'s (every
    rank), and on rank 0 the first step's gradients and the parameters
    after the last step, gathered and keyed by ``walk``'s keys (``g...``,
    ``p...``).  ``device`` "cuda" runs on the rank's card (a group with
    NCCL for CUDA tensors)."""
    mesh = make_mesh(shape, axes, device)
    dev = _device(device)
    mi = M.MeshInfo(mesh, dp_axes(mesh), "model")
    whole = CheckpointManager(ckpt_dir).restore(
        0, abstract_train_state(M.abstract_params(cfg), opt), dev)
    sspec = sh.train_state_specs(cfg, mesh)
    state = sh.distribute(whole, sspec, mesh)
    bspec = sh.batch_specs(cfg, mesh, dcfg.global_batch)
    batch0 = {k: torch.from_numpy(v).to(dev) for k, v in
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
        batch = sh.distribute({k: torch.from_numpy(v).to(dev) for k, v in
                               data.batch(i).items()}, bspec, mesh)
        if i == 0:
            _, grads = S.loss_and_grads(state["params"], cfg, batch,
                                        S.make_moe_fn(mi))
            out = {f"g{key}": _host(sh.full(g)) for (key, _, _), g in
                   zip(walk(state["params"]), grads)}
            del grads
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    for key, _, leaf in walk(sh.full(state["params"])):
        out[f"p{key}"] = _host(leaf)
    _save(out_dir, rank, losses=np.asarray(losses),
          grad_norms=np.asarray(norms), blocks=np.asarray(blocks, str),
          **(out if rank == 0 else {}))


def decode_inputs(path: str, cfg: ArchConfig, positions, batch: int = 4,
                  prompt: int = 16, max_len: int = 32, seed: int = 0) -> None:
    """``sharded_decode_rank``'s inputs for one model, written under
    ``path``: plain parameters from ``init_params`` (``seed``) as
    ``params.pt``, and ``in.npz`` with seeded prompt tokens (B,
    ``prompt``), ``max_len``, the decode ``pos``itions and a token for
    each (teacher-forced)."""
    rng = np.random.default_rng(seed + 1)
    torch.save(M.init_params(cfg, torch.Generator().manual_seed(seed),
                             "cpu"), os.path.join(path, "params.pt"))
    tmp = os.path.join(path, "in.tmp.npz")
    np.savez(tmp, tokens=rng.integers(0, cfg.vocab_size,
                                      (batch, prompt)).astype(np.int32),
             step_tokens=rng.integers(0, cfg.vocab_size,
                                      (len(positions), batch, 1))
             .astype(np.int32), pos=np.asarray(positions), max_len=max_len)
    os.replace(tmp, os.path.join(path, "in.npz"))


def sharded_decode_rank(rank: int, n: int, cases, shape: Tuple[int, ...],
                        axes: Tuple[str, ...], out_dir: str,
                        device: str = "cpu") -> None:
    """For each ``(name, cfg, path)`` of ``cases``: ``make_prefill_step``
    and teacher-forced ``make_decode_step`` steps over a mesh of every
    rank on DTensors placed by ``param_specs``, ``batch_specs`` and
    ``cache_specs_tree``, on the CPU or on the rank's card.  Inputs under
    ``path`` (``decode_inputs``): the plain parameter tree
    (``params.pt``) and ``in.npz``: ``tokens`` (B, T), ``max_len``, each
    decode step's ``pos`` and its tokens ``step_tokens`` (steps, B, 1).
    Outputs: ``<name>/logits`` (the prefill's last, then each step's,
    gathered, float32) and ``<name>/launches``, the decode kernel's
    launches in the decode steps."""
    from repro_torch.kernels.decode_attention import kernel as DK
    mesh = make_mesh(shape, axes, device)
    dev = _device(device)
    mi = M.MeshInfo(mesh, dp_axes(mesh), "model")
    out = {}
    for name, cfg, path in cases:
        params = tree_map(lambda t: t.to(dev),
                          torch.load(os.path.join(path, "params.pt")))
        with np.load(os.path.join(path, "in.npz")) as z:
            toks, max_len = torch.from_numpy(z["tokens"]).to(dev), \
                int(z["max_len"])
            steps = list(zip(z["pos"].tolist(), torch.from_numpy(
                z["step_tokens"]).to(dev)))
        B = toks.shape[0]
        tspec = sh.batch_specs(cfg, mesh, B)
        placed = sh.distribute(params, sh.param_specs(cfg, mesh), mesh)
        logits, cache = S.make_prefill_step(cfg, max_len, mi)(
            placed, sh.distribute({"tokens": toks}, tspec, mesh))
        cache = sh.distribute(cache, sh.cache_specs_tree(cfg, mesh, B),
                              mesh)
        got, before = [sh.full(logits)], DK.LAUNCHES
        decode = S.make_decode_step(cfg, mi)
        for pos, tok in steps:
            logits, cache = decode(placed, cache, sh.distribute(
                tok, tspec["tokens"], mesh), pos)
            got.append(sh.full(logits))
        out[f"{name}/logits"] = _host(torch.cat(got, 1))
        out[f"{name}/launches"] = DK.LAUNCHES - before
    _save(out_dir, rank, **out)


def serve_full(arch: str, mesh, batch: int = 4, prompt_len: int = 1024,
               max_len: int = 8192, steps: int = 32, seed: int = 0,
               reduced: bool = False, keep: int = 0):
    """``arch`` at its published widths (random weights, each rank
    drawing its own blocks with ``model.init_blocks``) over ``mesh`` (on
    the rank's card for a CUDA mesh), its kernels built first: twice
    ``make_prefill_step`` (cold: the first collectives and library
    handles; then warm) on ``batch`` seeded prompts of ``prompt_len``
    tokens into a ``max_len``-deep cache, the cache placed by
    ``cache_specs_tree``, ``steps`` greedy ``make_decode_step`` steps,
    then one step at a position inside the third block of the cache's
    cut sequence (the blocks before it fully valid, the last fully
    masked).  ``reduced`` takes the config's reduced widths (the CPU).

    Returns the record, ``sharded_serve_full_rank``'s outputs, and the
    run: ``params``, the ``decode`` step, the token placement ``tspec``,
    each decode step's ``positions`` and the tokens ``fed`` to it, and
    ``caches``, copies of the caches the first ``keep`` steps read."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.moe_route import kernel as RK
    from repro_torch.kernels.ssd_scan import kernel as SK
    kernels = {"decode_attention": DK, "moe_route": RK, "ssd_scan": SK}
    dev = _device(mesh.device_type)
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    mi = M.MeshInfo(mesh, dp_axes(mesh), "model")
    card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False

    def sync():
        if card:
            torch.cuda.synchronize(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) if card else 0
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_blocks(cfg, sh.param_specs(cfg, mesh), mesh, seed, dev)
    sync()
    init_s = time.perf_counter() - t0
    init_peak = peak()
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed + 1))
    tspec = sh.batch_specs(cfg, mesh, batch)
    prefill = S.make_prefill_step(cfg, max_len, mi)
    decode = S.make_decode_step(cfg, mi)
    if card:                            # the kernels' builds, untimed
        for mod in kernels.values():
            build.load(mod.NAME)
    prefill_ms = []
    for _ in range(2):                  # cold (groups, handles), then warm
        for mod in kernels.values():
            mod.LAUNCHES = 0
        L.DISPATCH = []
        logits = cache = None
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill(params, sh.distribute(
            {"tokens": toks.to(dev)}, tspec, mesh))
        cache = sh.distribute(cache, sh.cache_specs_tree(cfg, mesh, batch),
                              mesh)
        sync()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    pre = {k: m.LAUNCHES for k, m in kernels.items()}
    cuts = mesh.size(mesh.mesh_dim_names.index("model"))
    extra_pos = 2 * (max_len // cuts) + 10 if cuts > 2 else max_len - 1
    positions = [prompt_len + i for i in range(steps)] + [extra_pos]
    out, fed, step_ms, kept = [sh.full(logits)], [], [], []
    for pos in positions:
        tok = out[-1][:, -1].argmax(-1).to(torch.int32)[:, None]
        fed.append(tok)
        if len(kept) < keep:
            kept.append(tree_map(lambda t: t.clone(), cache))
        sync()
        t0 = time.perf_counter()
        logits, cache = decode(params, cache,
                               sh.distribute(tok, tspec["tokens"], mesh), pos)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(sh.full(logits))
    launches = {k: m.LAUNCHES - pre[k] for k, m in kernels.items()}
    drops = [L.dropped_pairs(r) for r in L.DISPATCH]
    L.DISPATCH = None
    rec = dict(prefill_ms=prefill_ms[1], prefill_cold_ms=prefill_ms[0],
               decode_ms=np.asarray(step_ms), init_s=init_s,
               peak_bytes=peak(), init_peak_bytes=init_peak,
               **{f"launches_prefill_{k}": v for k, v in pre.items()},
               **{f"launches_decode_{k}": v for k, v in launches.items()},
               dropped=int(sum(int(d) for d, _ in drops)),
               pairs=int(sum(int(a) for _, a in drops)),
               logits=_host(torch.cat(out, 1)),
               tokens=torch.cat(fed, 1).cpu().numpy(),
               card=dev.index if card else -1, extra_pos=extra_pos)
    return rec, dict(params=params, decode=decode, tspec=tspec,
                     positions=positions, fed=fed, caches=kept)


def sharded_serve_full_rank(rank: int, n: int, arch: str,
                            shape: Tuple[int, ...], axes: Tuple[str, ...],
                            out_dir: str, batch: int = 4,
                            prompt_len: int = 1024, max_len: int = 8192,
                            steps: int = 32, seed: int = 0,
                            device: str = "cuda",
                            reduced: bool = False) -> None:
    """``serve_full`` over a mesh of every rank, on the rank's card
    (``device="cpu"`` with ``reduced``: CPU ranks, plain versions, no
    memory readings).  Outputs: ``prefill_ms`` and ``prefill_cold_ms``,
    ``decode_ms`` (each step), ``init_s``, ``peak_bytes`` (the run's)
    and ``init_peak_bytes``, each kernel's ``launches_prefill_<name>`` /
    ``launches_decode_<name>``, ``dropped`` / ``pairs`` (``moe_ep``'s,
    this rank's experts), ``logits`` (the prefill's last and each
    step's, float32), ``tokens``, the ``card`` and the ``extra_pos``."""
    rec, _ = serve_full(arch, make_mesh(shape, axes, device), batch,
                        prompt_len, max_len, steps, seed, reduced)
    _save(out_dir, rank, **rec)
