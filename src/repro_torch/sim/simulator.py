"""The fleet scenario driver on the PyTorch port — the fleet part of
``repro.sim.simulator``: the paper's contention scenarios at 10k-node
scale (docs/DESIGN.md §8), with performance retention under contention
(paper §5.1) as the metric.

``alone`` selects the retention denominator: ``"analytic"`` (the
uncontended counterfactual, one vectorized run) or ``"none"`` (perf
only).  The reference's engine-driven alone modes are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.market import VolatilityControls
from repro_torch.core.topology import build_cluster
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim import traces
from repro_torch.sim.workloads import ON_DEMAND, Tenant, WorkloadParams


@dataclass
class ScenarioConfig:
    """The tenant-mix knobs ``make_tenants`` reads."""
    regime: str = "slight"          # right_sized | slight | heavy
    n_h100: int = 16
    n_a100: int = 16
    duration_s: float = 7200.0
    seed: int = 0
    n_training: int = 3
    n_inference: int = 3
    n_batch: int = 2
    overhead_mult: float = 1.0      # Fig 13


# oversubscription factors per regime (Faro demand regimes)
REGIME_DEMAND = {"right_sized": 1.0, "slight": 1.25, "heavy": 2.0}


def make_tenants(cfg: ScenarioConfig) -> List[Tenant]:
    """Tenant mix sized so aggregate peak demand hits the regime's
    oversubscription of cluster capacity (same draws, same order as
    the reference, from ``np.random.default_rng(cfg.seed)``)."""
    rng = np.random.default_rng(cfg.seed)
    capacity = cfg.n_h100 * 1.0 + cfg.n_a100 * 0.45
    demand_target = capacity * REGIME_DEMAND[cfg.regime]
    n_t = cfg.n_training + cfg.n_inference + cfg.n_batch
    share = demand_target / max(n_t, 1)
    tenants: List[Tenant] = []
    for i in range(cfg.n_training):
        nodes = max(1, int(round(share * rng.uniform(0.7, 1.3))))
        dl = cfg.duration_s * rng.uniform(0.7, 1.0)
        work = nodes * (dl / 3600.0) * 0.7    # satisfiable alone
        tenants.append(Tenant(
            f"train{i}",
            WorkloadParams(kind="training", work=work, deadline_s=dl,
                           checkpoint_interval_s=rng.uniform(180, 420),
                           reconfig_s=rng.uniform(60, 240),
                           max_nodes=nodes * 2,
                           value_per_gap=rng.uniform(15, 40)),
            arrival_s=rng.uniform(0, cfg.duration_s * 0.2),
            overhead_mult=cfg.overhead_mult))
    for i in range(cfg.n_inference):
        nodes = max(1, int(round(share * rng.uniform(0.7, 1.3))))
        base_rps = nodes * 10.0 * 0.6
        tenants.append(Tenant(
            f"infer{i}",
            WorkloadParams(kind="inference", deadline_s=cfg.duration_s,
                           reconfig_s=60.0,        # Dynamo ~1 min
                           max_nodes=nodes * 2,
                           rate_fn=traces.llm_request_rate(
                               cfg.seed * 101 + i, cfg.duration_s,
                               base_rps=base_rps),
                           sla_value_per_h=rng.uniform(30, 80)),
            arrival_s=rng.uniform(0, cfg.duration_s * 0.1),
            overhead_mult=cfg.overhead_mult))
    for i in range(cfg.n_batch):
        nodes = max(1, int(round(share * rng.uniform(0.7, 1.3))))
        dl = cfg.duration_s * rng.uniform(0.8, 1.0)
        work = nodes * (dl / 3600.0) * 0.6
        tenants.append(Tenant(
            f"batch{i}",
            WorkloadParams(kind="batch", work=work, deadline_s=dl,
                           checkpoint_interval_s=600.0,
                           reconfig_s=rng.uniform(240, 720),  # Parabricks
                           max_nodes=nodes * 2,
                           value_per_gap=rng.uniform(8, 20)),
            arrival_s=rng.uniform(0, cfg.duration_s * 0.3),
            overhead_mult=cfg.overhead_mult))
    return tenants


@dataclass
class FleetScenarioConfig:
    """Scale-path scenario: one homogeneous type-tree, regime-scaled
    tenant mix, every epoch one batch into the engine."""
    regime: str = "heavy"
    n_leaves: int = 2048
    n_training: int = 24
    n_inference: int = 24
    n_batch: int = 16
    duration_s: float = 1800.0
    tick_s: float = 60.0
    seed: int = 0
    k: int = 16                     # top-K cascade width at fleet scale
    b_max: int = 1024               # bid-batch capacity per epoch
    per_tenant_bids: int = 8
    alone: str = "analytic"         # retention denominator: "analytic"
    #   (uncontended counterfactual) or "none" (perf only)
    controls: VolatilityControls = field(
        default_factory=lambda: VolatilityControls(max_bid_multiple=4.0,
                                                   floor_fall_rate=0.5,
                                                   min_holding_s=600.0))

    @property
    def n_tenants(self) -> int:
        return self.n_training + self.n_inference + self.n_batch


# The paper's scale claim as one scenario: the 10k case of
# benchmarks/fig06_contention.py SCALE_CASES (the committed
# fig06/scale/fused_epoch/backend=jnp/n=10000 row) -- 1,000 tenants,
# 21 epochs, a 16,384-slot bid table -- with perf only (its engine-sampled
# retention denominator is not ported; orders and transfers do not use it).
FLEET_10K = dict(regime="heavy", n_leaves=10000, n_training=384,
                 n_inference=384, n_batch=232, duration_s=1200.0,
                 tick_s=60.0, seed=1, k=16, b_max=8192, per_tenant_bids=8,
                 alone="none")


@dataclass
class FleetRunResult:
    perf: np.ndarray                 # (n_tenants,) multi-tenant run
    alone_perf: np.ndarray           # (n_tenants,) denominator (or ones)
    retention: np.ndarray            # clip(perf / alone, 1.5)
    epoch_s: List[float]             # wall-clock per multi-run epoch
    stats: Dict[str, float]
    engine_state: dict = field(default_factory=dict)  # final, on device

    @property
    def mean_retention(self) -> float:
        return float(np.mean(self.retention)) if len(self.retention) \
            else float("nan")


def make_fleet(fcfg: FleetScenarioConfig, device: DeviceLike = None):
    """Build ``(topo, tenants, market, fleet, params)`` for a fleet
    scenario on ``device`` (``None`` = CUDA).  The fleet is
    locality-free, so the reference's ``topology_sensitive`` flag (which
    it forces off here) has no counterpart."""
    from repro_torch.market_torch.bridge import BatchMarket
    from repro_torch.sim.fleet import Fleet, FleetConfig, \
        params_from_tenants
    dev = resolve_device(device)
    topo = build_cluster({"H100": fcfg.n_leaves}, gpus_per_host=8,
                         hosts_per_rack=4, racks_per_zone=4)
    scfg = ScenarioConfig(
        regime=fcfg.regime, n_h100=fcfg.n_leaves, n_a100=0,
        duration_s=fcfg.duration_s, seed=fcfg.seed,
        n_training=fcfg.n_training, n_inference=fcfg.n_inference,
        n_batch=fcfg.n_batch)
    tenants = make_tenants(scfg)
    cap = 1 << max(11, (2 * fcfg.b_max - 1).bit_length())
    market = BatchMarket(topo, fcfg.controls, capacity=cap,
                         n_tenants=len(tenants) + 1, k=fcfg.k, device=dev)
    fleet = Fleet(FleetConfig(n=len(tenants), b_max=fcfg.b_max,
                              per_tenant_bids=fcfg.per_tenant_bids),
                  market.engines["H100"].tree, device=dev)
    params = params_from_tenants(tenants, fcfg.duration_s, device=dev)
    return topo, tenants, market, fleet, params


def _seed_floors(market, topo) -> None:
    for rtype, root in topo.roots.items():
        market.set_floor(root, ON_DEMAND.get(rtype, 2.0) * 0.7)


def _drive_fleet_fused(fleet, params, market, fcfg: FleetScenarioConfig):
    """The multi-tenant fleet loop (``sim/epoch.py``).  Returns
    ``(fleet_state, epoch_s, bids_clipped)``."""
    from repro_torch.sim.epoch import EpochRunner
    runner = EpochRunner(market, fleet)
    state = fleet.init_state(params)
    state, epoch_s, stats = runner.drive(params, state, fcfg.duration_s,
                                         fcfg.tick_s)
    return state, epoch_s, stats["bids_clipped"]


def _alone_analytic(fleet, params, fcfg: FleetScenarioConfig
                    ) -> np.ndarray:
    """Uncontended counterfactual, one vectorized run: grant desired
    nodes at once (``resize_to_desired``), advance."""
    n = fcfg.n_tenants
    state = fleet.init_state(params)
    held = torch.zeros((n,), dtype=torch.int32, device=fleet.device)
    t = 0.0
    while t <= fcfg.duration_s:
        state, held = fleet.resize_to_desired(params, state, t, held)
        state = fleet.advance(params, state, t, held)
        t += fcfg.tick_s
    return fleet.performance(params, state, fcfg.duration_s).cpu().numpy()


def _check_alone(mode: str) -> None:
    if mode in ("engine", "engine_sampled"):
        raise NotImplementedError(
            f"alone={mode!r} (engine-driven alone runs) is not ported "
            "yet; use 'analytic' or 'none'")
    if mode not in ("none", "analytic"):
        raise ValueError(f"unknown alone mode {mode!r}")


def run_fleet_scenario(fcfg: FleetScenarioConfig,
                       device: DeviceLike = None) -> FleetRunResult:
    """Multi-tenant fleet run (+ alone denominator) => retention under
    contention, with per-epoch wall times, on ``device`` (``None`` =
    CUDA)."""
    _check_alone(fcfg.alone)
    topo, tenants, market, fleet, params = make_fleet(fcfg, device)
    _seed_floors(market, topo)
    state, epoch_s, clipped = _drive_fleet_fused(fleet, params, market,
                                                 fcfg)
    perf = fleet.performance(params, state,
                             fcfg.duration_s).cpu().numpy()
    stats = dict(market.stats)
    stats["bids_clipped"] = clipped
    alone = _alone_analytic(fleet, params, fcfg) \
        if fcfg.alone == "analytic" else np.ones(fcfg.n_tenants, np.float32)
    retention = np.minimum(1.5, perf / np.maximum(alone, 1e-9))
    return FleetRunResult(perf=perf, alone_perf=alone,
                          retention=retention, epoch_s=epoch_s,
                          stats=stats,
                          engine_state=market.states["H100"])
