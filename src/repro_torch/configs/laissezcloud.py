"""The paper's own configuration: the LaissezCloud market + cluster setup.

This is not an LM architecture — it is the cloud being reproduced:
cluster compositions (right-sized / slightly / heavily oversubscribed per
Faro's demand regimes), GPU pool mix, market parameters (volatility bounds,
operator floor pricing at ~break-even under 70% utilization), and tenant
mix used across §5 of the paper.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class MarketParams:
    # operator base (floor) prices, $/hour, anchored to public H100/A100
    # on-demand rates scaled by 0.7 to approximate break-even at full
    # utilization under a 70% average-utilization assumption [56].
    base_price: Dict[str, float] = field(default_factory=lambda: {
        "H100": 4.76 * 0.7,
        "A100": 3.67 * 0.7,
    })
    # volatility controls (paper §4.2, §5.5.2)
    max_bid_multiple: float = 4.0       # clip incoming bids vs current rate
    floor_fall_rate: float = 0.5        # max fractional floor drop per hour
    min_holding_s: float = 0.0          # optional min holding time
    handoff_latency_s: float = 0.05     # 10-100 ms physical handoff


@dataclass(frozen=True)
class ClusterRegime:
    """Cluster composition for a contention regime (Faro demand regimes)."""
    name: str
    n_h100: int
    n_a100: int
    oversubscription: float    # aggregate peak tenant demand / capacity


REGIMES: Dict[str, ClusterRegime] = {
    # aggregate tenant peak demand vs capacity: 1.0 / 1.25 / 2.0
    "right_sized": ClusterRegime("right_sized", 32, 32, 1.0),
    "slight":      ClusterRegime("slight",      32, 32, 1.25),
    "heavy":       ClusterRegime("heavy",       32, 32, 2.0),
}


@dataclass(frozen=True)
class TopologyParams:
    """Topology tree shape: zones -> racks -> hosts (NVLink) -> GPUs."""
    gpus_per_host: int = 8
    hosts_per_rack: int = 4
    racks_per_zone: int = 4


@dataclass(frozen=True)
class LaissezCloudConfig:
    market: MarketParams = field(default_factory=MarketParams)
    topology: TopologyParams = field(default_factory=TopologyParams)
    # reconfiguration overheads (seconds), from paper Table 1
    reconfig_s: Dict[str, Tuple[float, float]] = field(default_factory=lambda: {
        "inference": (60.0, 60.0),       # Dynamo ~1 min
        "training":  (60.0, 240.0),      # Sailor 1-4 min
        "batch":     (240.0, 720.0),     # Parabricks 4-12 min
    })
    # request rates used to size the engine benchmark (§5.5.1)
    reqs_per_s: Dict[str, float] = field(default_factory=lambda: {
        "training": 3.0, "inference": 10.0,
    })


CONFIG = LaissezCloudConfig()
