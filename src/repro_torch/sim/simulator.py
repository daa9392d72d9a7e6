"""Simulation runs on the PyTorch port — the twin of
``repro.sim.simulator``, with performance retention under contention
(paper §5.1) as the metric: per-tenant performance in a multi-tenant
run divided by the same tenant's performance running alone.

Two entry points: ``run_once`` / ``run_with_retention`` step the object
tenants through one of the clouds of ``sim/cloud.py`` (the event-driven
path: every market call of ``laissez_batch`` is one engine step behind
the ``BatchMarket`` facade), and ``run_fleet_scenario`` runs the
paper's contention scenarios at 10k-node scale on the vectorized fleet
(docs/DESIGN.md §8).

``alone`` selects the retention denominator (see
``FleetScenarioConfig``).  The engine-alone runs go through the same
``EpochRunner.drive`` as the multi-tenant run; the reference's unfused
six-dispatch loop, which exists there only as the bit-identity twin of
its fused epoch, has no counterpart here.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.econadapter import AdapterConfig
from repro_torch.core.market import VolatilityControls
from repro_torch.core.topology import Topology, build_cluster
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim import traces
from repro_torch.sim.cloud import CloudBase, FCFSCloud, FCFSPCloud, \
    LaissezBatchCloud, LaissezCloud, SpotCloud
from repro_torch.sim.workloads import ON_DEMAND, Tenant, WorkloadParams


@dataclass
class ScenarioConfig:
    regime: str = "slight"          # right_sized | slight | heavy
    n_h100: int = 16
    n_a100: int = 16
    duration_s: float = 7200.0
    tick_s: float = 30.0
    seed: int = 0
    n_training: int = 3
    n_inference: int = 3
    n_batch: int = 2
    overhead_mult: float = 1.0      # Fig 13
    reconfig_estimate_mult: float = 1.0  # Fig 15
    controls: VolatilityControls = field(
        default_factory=lambda: VolatilityControls(max_bid_multiple=4.0,
                                                   floor_fall_rate=0.5,
                                                   min_holding_s=600.0))
    # min_holding_s ~ the largest reconfig overhead: a node must get
    # the chance to amortize its restart before a limit crossing can
    # evict it (docs/DESIGN.md §13)
    topology_aware: bool = True     # Fig 10 toggle


# oversubscription factors per regime (Faro demand regimes)
REGIME_DEMAND = {"right_sized": 1.0, "slight": 1.25, "heavy": 2.0}


def make_tenants(cfg: ScenarioConfig, topo: Topology) -> List[Tenant]:
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
                           topology_sensitive=True,
                           value_per_gap=rng.uniform(15, 40)),
            topo, arrival_s=rng.uniform(0, cfg.duration_s * 0.2),
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
            topo, arrival_s=rng.uniform(0, cfg.duration_s * 0.1),
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
                           topology_sensitive=False,
                           value_per_gap=rng.uniform(8, 20)),
            topo, arrival_s=rng.uniform(0, cfg.duration_s * 0.3),
            overhead_mult=cfg.overhead_mult))
    return tenants


def build_cloud(kind: str, topo: Topology, cfg: ScenarioConfig,
                device: DeviceLike = None) -> CloudBase:
    if kind == "fcfs":
        return FCFSCloud(topo)
    if kind == "fcfsp":
        return FCFSPCloud(topo)
    if kind == "spot":
        return SpotCloud(topo)
    if kind == "laissez":
        return LaissezCloud(topo, cfg.controls)
    if kind == "laissez_batch":
        return LaissezBatchCloud(topo, cfg.controls, device=device)
    raise ValueError(f"unknown cloud kind {kind!r}")


@dataclass
class RunResult:
    perf: Dict[str, float]
    cost: Dict[str, float]
    retention: Dict[str, float] = field(default_factory=dict)
    stats: Dict[str, float] = field(default_factory=dict)

    @property
    def mean_retention(self) -> float:
        vals = list(self.retention.values())
        return statistics.fmean(vals) if vals else float("nan")


def run_once(kind: str, cfg: ScenarioConfig,
             only_tenant: Optional[str] = None,
             device: DeviceLike = None) -> RunResult:
    """One scenario run of cloud ``kind`` (``only_tenant``: that tenant
    alone).  ``device`` (``None`` = CUDA) is where ``laissez_batch``'s
    engines run; the other clouds are host Python."""
    dev = resolve_device(device)
    topo = build_cluster({"H100": cfg.n_h100, "A100": cfg.n_a100},
                         gpus_per_host=4, hosts_per_rack=2,
                         racks_per_zone=2)
    cloud = build_cloud(kind, topo, cfg, dev)
    tenants = make_tenants(cfg, topo)
    if only_tenant is not None:
        tenants = [t for t in tenants if t.name == only_tenant]
    acfg = AdapterConfig(
        topology_aware=cfg.topology_aware,
        reconfig_estimate_mult=cfg.reconfig_estimate_mult)
    for t in tenants:
        if isinstance(cloud, LaissezCloud):
            cloud.add_tenant(t, acfg)
        else:
            cloud.add_tenant(t)
    t = 0.0
    while t <= cfg.duration_s:
        cloud.step(t)
        for tn in cloud.tenants.values():
            tn.advance(t)
        t += cfg.tick_s
    perf = {tn.name: tn.performance(cfg.duration_s)
            for tn in cloud.tenants.values()}
    cost = {tn.name: cloud.cost_of(tn.name)
            for tn in cloud.tenants.values()}
    stats = {}
    if isinstance(cloud, LaissezCloud):
        stats = dict(cloud.market.stats)
    elif isinstance(cloud, SpotCloud):
        stats = dict(cloud.stats)
    return RunResult(perf=perf, cost=cost, stats=stats)


def run_with_retention(kind: str, cfg: ScenarioConfig,
                       device: DeviceLike = None) -> RunResult:
    """Multi-tenant run + per-tenant alone runs => retention (Fig 6)."""
    multi = run_once(kind, cfg, device=device)
    for name in list(multi.perf):
        alone = run_once(kind, cfg, only_tenant=name, device=device)
        denom = max(alone.perf[name], 1e-9)
        multi.retention[name] = min(1.5, multi.perf[name] / denom)
    return multi


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
    alone: str = "analytic"         # retention denominator:
    #   "analytic" — uncontended counterfactual, one vectorized run
    #   "engine"   — per-tenant alone runs through the engine (toy scale)
    #   "engine_sampled" — engine-alone for a per-kind sample, analytic
    #                 x per-kind engine/analytic ratio for the rest
    #   "none"     — skip (perf only)
    alone_sample: int = 4           # per-kind sample size (engine_sampled)
    faults: Optional[list] = None   # fault schedule: a list of
    # sim.faults.FaultEvent records; a fresh FaultInjector is built per
    # drive (so alone runs and reruns replay the identical schedule)
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
# 21 epochs, a 16,384-slot bid table, the sampled engine-alone retention
# denominator (4 tenants of each kind).
FLEET_10K = dict(regime="heavy", n_leaves=10000, n_training=384,
                 n_inference=384, n_batch=232, duration_s=1200.0,
                 tick_s=60.0, seed=1, k=16, b_max=8192, per_tenant_bids=8,
                 alone="engine_sampled", alone_sample=4)


@dataclass
class FleetRunResult:
    perf: np.ndarray                 # (n_tenants,) multi-tenant run
    alone_perf: np.ndarray           # (n_tenants,) denominator (or ones)
    retention: np.ndarray            # clip(perf / alone, 1.5)
    epoch_s: List[float]             # wall-clock per multi-run epoch
    stats: Dict[str, float]
    engine_state: dict = field(default_factory=dict)  # final multi-tenant
    # engine state, on device
    alone_s: float = 0.0             # wall seconds of the denominator
    alone_waves: List[int] = field(default_factory=list)  # cascade waves
    # of each engine-alone run (none when the denominator was cached)

    @property
    def mean_retention(self) -> float:
        return float(np.mean(self.retention)) if len(self.retention) \
            else float("nan")


def make_fleet(fcfg: FleetScenarioConfig, device: DeviceLike = None):
    """Build ``(topo, tenants, market, fleet, params)`` for a fleet
    scenario on ``device`` (``None`` = CUDA).  Tenant mixes reuse
    ``make_tenants``'s regime scaling on a single H100 tree, with
    ``topology_sensitive`` forced off: the fleet is locality-free."""
    from repro_torch.market_torch.bridge import BatchMarket
    from repro_torch.sim.fleet import Fleet, FleetConfig, \
        params_from_tenants
    dev = resolve_device(device)
    topo = build_cluster({"H100": fcfg.n_leaves}, gpus_per_host=8,
                         hosts_per_rack=4, racks_per_zone=4)
    scfg = ScenarioConfig(
        regime=fcfg.regime, n_h100=fcfg.n_leaves, n_a100=0,
        duration_s=fcfg.duration_s, tick_s=fcfg.tick_s, seed=fcfg.seed,
        n_training=fcfg.n_training, n_inference=fcfg.n_inference,
        n_batch=fcfg.n_batch, controls=fcfg.controls)
    tenants = make_tenants(scfg, topo)
    for t in tenants:
        t.p.topology_sensitive = False
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


def _make_injector(fcfg: FleetScenarioConfig):
    """A fresh injector per drive: consumption pointers are run-local,
    so alone runs and reruns replay the identical schedule."""
    if not fcfg.faults:
        return None
    from repro_torch.sim.faults import FaultInjector
    return FaultInjector(fcfg.faults)


def _drive_fleet_fused(fleet, params, market, fcfg: FleetScenarioConfig):
    """The multi-tenant fleet loop (``sim/epoch.py``).  Returns
    ``(fleet_state, epoch_s, bids_clipped)``."""
    from repro_torch.sim.epoch import EpochRunner
    runner = EpochRunner(market, fleet)
    state = fleet.init_state(params)
    state, epoch_s, stats = runner.drive(params, state, fcfg.duration_s,
                                         fcfg.tick_s,
                                         injector=_make_injector(fcfg))
    return state, epoch_s, stats["bids_clipped"]


# The denominator is cloud-independent (the uncontended counterfactual),
# so runs of every cloud at the same configuration share one
# computation.  Keyed on the config repr and the device: a card run is
# never handed a CPU result, nor a CPU run a card result.
_ALONE_CACHE: Dict[tuple, np.ndarray] = {}


def _alone_perf(fleet, params, market, topo, fcfg: FleetScenarioConfig,
                waves: Optional[List[int]] = None) -> np.ndarray:
    """Retention denominator — see ``FleetScenarioConfig.alone``.
    ``waves``, when given, collects each engine-alone run's cascade
    waves."""
    n = fcfg.n_tenants
    if fcfg.alone == "none":
        return np.ones(n, np.float32)
    key = (repr(fcfg), str(fleet.device))
    cached = _ALONE_CACHE.get(key)
    if cached is not None:
        return cached.copy()
    if fcfg.alone == "analytic":
        out = _alone_analytic(fleet, params, fcfg)
    elif fcfg.alone == "engine_sampled":
        out = _alone_engine_sampled(fleet, params, market, topo, fcfg,
                                    waves)
    else:
        out = np.ones(n, np.float32)
        for i in range(n):
            out[i] = _alone_engine_one(fleet, params, market, topo, fcfg,
                                       i, waves)
    _ALONE_CACHE[key] = out.copy()
    return out


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


def _alone_engine_one(fleet, params, market, topo,
                      fcfg: FleetScenarioConfig, i: int,
                      waves: Optional[List[int]] = None) -> float:
    """One tenant's alone performance through the real engine loop, on
    a reset market (``params_alone`` keeps every shape)."""
    from repro_torch.sim.fleet import params_alone
    market.reset()
    _seed_floors(market, topo)
    p_i = params_alone(params, i)
    state, _, _ = _drive_fleet_fused(fleet, p_i, market, fcfg)
    if waves is not None:
        waves.append(int(market.states["H100"]["waves"]))
    return float(fleet.performance(p_i, state, fcfg.duration_s)[i])


def _alone_engine_sampled(fleet, params, market, topo,
                          fcfg: FleetScenarioConfig,
                          waves: Optional[List[int]] = None) -> np.ndarray:
    """Sampled engine-alone denominator for fleet scale: the engine
    alone loop for an evenly spaced per-kind sample of tenants, and the
    analytic counterfactual corrected by its kind's mean engine/analytic
    ratio for every other tenant.  At ``alone_sample >= tenants per
    kind`` this is ``alone="engine"``."""
    analytic = _alone_analytic(fleet, params, fcfg)
    kinds = params["kind"].cpu().numpy()
    out = analytic.copy()
    for kind in np.unique(kinds):
        idx = np.nonzero(kinds == kind)[0]
        k = min(max(fcfg.alone_sample, 1), len(idx))
        sampled = idx[np.unique(np.linspace(0, len(idx) - 1, k)
                                .round().astype(int))]
        ratios = []
        for i in sampled:
            engine_i = _alone_engine_one(fleet, params, market, topo,
                                         fcfg, int(i), waves)
            ratios.append(engine_i / max(float(analytic[i]), 1e-9))
            out[i] = engine_i
        ratio = float(np.mean(ratios)) if ratios else 1.0
        rest = np.setdiff1d(idx, sampled)
        out[rest] = analytic[rest] * ratio
    return out


def _check_alone(mode: str) -> None:
    if mode not in ("none", "analytic", "engine", "engine_sampled"):
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
    # take the multi-tenant stats and engine state before the alone
    # runs: each engine-alone run resets the market
    stats = dict(market.stats)
    stats["bids_clipped"] = clipped
    engine_state = market.states["H100"]
    waves: List[int] = []
    t0 = time.perf_counter()
    alone = _alone_perf(fleet, params, market, topo, fcfg, waves)
    alone_s = time.perf_counter() - t0
    retention = np.minimum(1.5, perf / np.maximum(alone, 1e-9))
    return FleetRunResult(perf=perf, alone_perf=alone,
                          retention=retention, epoch_s=epoch_s,
                          stats=stats, engine_state=engine_state,
                          alone_s=alone_s, alone_waves=waves)
