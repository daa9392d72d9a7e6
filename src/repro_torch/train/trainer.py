"""The market-driven, elastic trainer of the port, twin of
``repro.train.trainer``.

The training loop is the tenant application from LaissezCloud's point
of view: a ``ResourceBroker`` (fixed, scheduled, or reading a live
``core.market.Market``) says how many devices the tenant owns.  On a
grant or a revoke the trainer re-meshes (a new data-parallel degree)
and goes on from the same state: the shrink-and-continue behaviour of
the paper's Table 2; it also checkpoints every N steps and resumes from
the latest checkpoint (checkpoint-restart).  A straggler EWMA of the
step time flags slow steps and reports them to the broker as a utility
drop.

Every rank of the default process group runs ``run`` (one rank, made on
the fly, when there is no group).  The mesh is ``(n, 1)`` over
("data", "model") on ranks ``0 .. n - 1``, as the reference's
``_build`` makes it, so the MoE layers run the reference's
capacity-limited ``moe_ep`` on one device too.  Only rank 0's broker
decides: it says ``n`` every step and rank 0 broadcasts it.  Ranks
outside the mesh sit the step out.  The state is held as DTensors in
the reference's placements (``train_state_specs``: the parameters and
the AdamW state FSDP-sharded over "data"), and the batch as the global
batch cut over "data".  A checkpoint gathers the state whole
(``full_tensor``) and rank 0 writes it; on a resize the old mesh gathers
it, every rank receives rank 0's copy by broadcast (the reference's host
snapshot) and the new mesh distributes it; a restore distributes the
checkpoint onto the mesh.  ``run`` ends with the state gathered whole
on the mesh's ranks (plain tensors), as the reference's sharded arrays
read whole.  Every rank reports rank 0's losses.  The reference's ``TrainConfig.log_every`` (read
nowhere) and ``scan_layers`` (the port's layers run unrolled) are left
out.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import ensure_default_group, in_mesh, make_mesh
from repro_torch.models import model as M
from repro_torch.models import steps as S
from repro_torch.optim import (AdamWConfig, abstract_train_state,
                               make_train_state)
from repro_torch.tree import tree_map


@dataclass
class TrainConfig:
    steps: int = 200
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    async_checkpoint: bool = True
    straggler_factor: float = 2.0     # step > factor x EWMA => straggler
    seed: int = 0


class ResourceBroker:
    """Fixed-allocation broker (baseline). Market-driven subclass below."""

    def __init__(self, n_devices: int) -> None:
        self.n = n_devices

    def current_devices(self, step: int) -> int:
        return self.n

    def report_degradation(self, step: int, slowdown: float) -> None:
        pass


class ScheduledBroker(ResourceBroker):
    """Deterministic grant/revoke schedule — used to test elasticity and
    to replay market decisions: {step: n_devices}."""

    def __init__(self, schedule: Dict[int, int], n0: int) -> None:
        super().__init__(n0)
        self.schedule = dict(schedule)

    def current_devices(self, step: int) -> int:
        for s in sorted(self.schedule):
            if step >= s:
                self.n = self.schedule[s]
        return self.n


class MarketBroker(ResourceBroker):
    """Drives device count from a live LaissezCloud market
    (``repro_torch.core.market.Market``): owned leaves of this tenant =>
    data-parallel degree (capped at ``max_devices``)."""

    def __init__(self, market, tenant: str, max_devices: int) -> None:
        super().__init__(1)
        self.market = market
        self.tenant = tenant
        self.max = max_devices

    def current_devices(self, step: int) -> int:
        owned = len(self.market.owned_leaves(self.tenant))
        n = max(1, min(self.max, owned))
        # mesh size must divide batch cleanly; use the largest power of 2
        while n & (n - 1):
            n -= 1
        return n


@dataclass
class TrainReport:
    losses: List[float] = field(default_factory=list)
    resizes: List[Tuple[int, int, int]] = field(default_factory=list)
    restores: int = 0
    stragglers: int = 0
    steps_done: int = 0
    step_s: List[float] = field(default_factory=list)   # host clock a step


class Trainer:
    def __init__(self, cfg: ArchConfig, data_cfg: DataConfig,
                 opt: Optional[AdamWConfig] = None,
                 tcfg: Optional[TrainConfig] = None,
                 broker: Optional[ResourceBroker] = None,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.opt = opt or AdamWConfig(state_dtype=cfg.opt_dtype)
        self.tcfg = tcfg or TrainConfig()
        self.broker = broker or ResourceBroker(1)
        self.device = resolve_device(device)
        self.data = SyntheticTokens(data_cfg)
        self.ckpt = CheckpointManager(self.tcfg.checkpoint_dir)
        self.mesh = None
        self._train_step = None
        self._place = None          # the state's placement on the mesh
        self._bspec = None          # the batch's
        self.state = None

    # ------------------------------------------------------------ meshes
    def _build(self, n_devices: int, state: Optional[Any]) -> None:
        """(Re)build the mesh and the step over ``n_devices`` ranks and
        keep this rank's block of ``state`` (None outside the mesh)."""
        tp = 1                                    # DP-only elastic
        self.mesh = make_mesh((n_devices, tp), ("data", "model"),
                              self.device)
        mi = M.MeshInfo(self.mesh, ("data",), "model")
        self._train_step = S.make_train_step(self.cfg, self.opt, mi) \
            if in_mesh(self.mesh) else None
        self._place = sh.train_state_specs(self.cfg, self.mesh)
        self._bspec = sh.batch_specs(self.cfg, self.mesh,
                                     self.data_cfg.global_batch)
        self.state = sh.distribute(state, self._place, self.mesh) \
            if state is not None and in_mesh(self.mesh) else None

    def _step(self, state, batch):
        return self._train_step(state, batch)

    def _agree(self, value, dtype=torch.int64):
        """Rank 0's ``value`` on every rank."""
        t = torch.tensor(value, dtype=dtype, device=self.device)
        dist.broadcast(t, src=0)
        return t.item()

    def _template(self):
        return abstract_train_state(M.abstract_params(self.cfg), self.opt)

    def _whole(self):
        """The state gathered whole on the mesh's ranks (None outside)."""
        return sh.full(self.state) if in_mesh(self.mesh) else None

    def _share(self, state):
        """Rank 0's whole state on every rank (each leaf broadcast)."""
        def leaf(t):
            if dist.get_rank() != 0:
                t = torch.empty(t.shape, dtype=t.dtype, device=self.device)
            dist.broadcast(t.detach(), src=0)
            return t
        return tree_map(leaf, state if dist.get_rank() == 0
                        else self._template())

    def _init_state(self):
        """Fresh parameters drawn on the device from ``torch.Generator``
        seeded with ``TrainConfig.seed``, and zero AdamW state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        return make_train_state(M.init_params(self.cfg, gen, self.device),
                                self.opt)

    # ------------------------------------------------------------- loop
    def run(self, resume: bool = True) -> TrainReport:
        rep = TrainReport()
        tc = self.tcfg
        ensure_default_group(self.device)
        rank0 = dist.get_rank() == 0
        n_dev = self._agree(self.broker.current_devices(0))
        latest = self.ckpt.latest_step() if resume and rank0 else None
        start = self._agree(-1 if latest is None else latest)
        self._build(n_dev, None)
        if in_mesh(self.mesh):
            self.state = sh.distribute(
                self.ckpt.restore(start, self._template(), self.device)
                if start >= 0 else self._init_state(), self._place,
                self.mesh)
        if start >= 0:
            rep.restores += 1
        start = max(start, 0)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        ewma = None
        for step in range(start, tc.steps):
            want = self._agree(self.broker.current_devices(step))
            if want != n_dev:
                # elastic re-mesh: rank 0's state -> rebuild -> go on
                rep.resizes.append((step, n_dev, want))
                n_dev = want
                self._build(n_dev, self._share(self._whole()))
            dt = 0.0
            loss = float("nan")
            if in_mesh(self.mesh):
                batch = sh.distribute(
                    {k: torch.from_numpy(v).to(self.device) for k, v in
                     self.data.batch(step).items()}, self._bspec, self.mesh)
                sync()
                t0 = time.perf_counter()
                self.state, metrics = self._step(self.state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                if ewma is None:
                    ewma = dt
                elif step > start + 2:
                    if dt > tc.straggler_factor * ewma:
                        rep.stragglers += 1
                        self.broker.report_degradation(step, dt / ewma)
                    ewma += 0.2 * (dt - ewma)
            rep.losses.append(self._agree(loss, torch.float64))
            rep.step_s.append(dt)
            rep.steps_done = step + 1
            if (step + 1) % tc.checkpoint_every == 0:
                whole = self._whole()           # collective on the mesh
                if rank0:
                    self.ckpt.save(step + 1, whole,
                                   blocking=not tc.async_checkpoint)
                del whole
        self.state = self._whole()
        self.ckpt.wait()
        return rep
