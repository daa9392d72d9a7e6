"""The market-driven trainer of the port, twin of
``repro.train.trainer`` on one device.

The training loop is the tenant application from LaissezCloud's point
of view: a ``ResourceBroker`` (fixed, scheduled, or reading a live
``core.market.Market``) says how many devices the tenant owns, and the
trainer checkpoints every N steps and resumes from the latest
checkpoint.  A straggler EWMA of the step time flags slow steps and
reports them to the broker as a utility drop.

The port trains on one device: a broker that asks for another device
count makes ``run`` raise ``NotImplementedError``.  The resizes need
the mesh of ``launch/`` (ROADMAP Queue 1 item 4); the reference builds a
mesh even for one device, so it runs the expert-parallel MoE where the
port runs ``moe_dense``.  The reference's ``TrainConfig.log_every`` (read
nowhere) and ``TrainReport.resizes`` (the port never resizes) are left
out.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models import steps as S
from repro_torch.optim import (AdamWConfig, abstract_train_state,
                               make_train_state)


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
        self._step = S.make_train_step(cfg, self.opt)
        self.state = None

    def _need_one_device(self, step: int, n_devices: int) -> None:
        if n_devices != 1:
            raise NotImplementedError(
                f"the broker asks for {n_devices} devices at step {step}; "
                "the port trains on one device (resizes need launch/, "
                "ROADMAP Queue 1 item 4)")

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
        self._need_one_device(0, self.broker.current_devices(0))
        start = 0
        if resume and self.ckpt.latest_step() is not None:
            start = self.ckpt.latest_step()
            template = abstract_train_state(M.abstract_params(self.cfg),
                                            self.opt)
            self.state = self.ckpt.restore(start, template, self.device)
            rep.restores += 1
        else:
            self.state = self._init_state()
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        ewma = None
        for step in range(start, tc.steps):
            self._need_one_device(step, self.broker.current_devices(step))
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(step).items()}
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
            rep.losses.append(loss)
            rep.step_s.append(dt)
            rep.steps_done = step + 1
            if (step + 1) % tc.checkpoint_every == 0:
                self.ckpt.save(step + 1, self.state,
                               blocking=not tc.async_checkpoint)
        self.ckpt.wait()
        return rep
