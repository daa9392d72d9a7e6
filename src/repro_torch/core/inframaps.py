"""InfraMaps: operator-side telemetry -> price policy (paper §4.6, §5.4),
copied from ``repro.core.inframaps``.

InfraMaps consume DCIM-style inputs (power/cooling headroom, maintenance
plans, utilization) and inject them into the market as floor-price
adjustments, reclaim pressure and volatility bounds — without exposing the
telemetry itself.  The power policy is deliberately tiny (the paper reports
3 lines mapping headroom to a proportional price adjustment; ours is the
same arithmetic).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core.market import Market


@dataclass
class InfraMapConfig:
    base_price: float = 2.0
    power_coeff: float = 4.0       # price multiplier slope vs overuse
    maintenance_price: float = 1e6  # effectively evict-by-price


class InfraMap:
    """Base: composes weighted per-node price adjustments into floors."""

    def __init__(self, market: Market, cfg: Optional[InfraMapConfig] = None
                 ) -> None:
        self.market = market
        self.cfg = cfg or InfraMapConfig()
        self._adjusters: List[Callable[[float, int], float]] = []

    def add_adjuster(self, fn: Callable[[float, int], float]) -> None:
        """fn(now, node_id) -> additive $/h floor adjustment."""
        self._adjusters.append(fn)

    def step(self, now: float, nodes: List[int]) -> None:
        self.market.advance_to(now)
        for node in nodes:
            adj = sum(fn(now, node) for fn in self._adjusters)
            self.market.set_floor(node, max(0.0, self.cfg.base_price + adj))


class PowerAwareInfraMap(InfraMap):
    """Fig 11: raise a power domain's floor as its headroom shrinks.

    The telemetry-to-price mapping is the paper's 3-liner:
        overuse = max(0, used/cap - target)
        floor   = base * (1 + coeff * overuse)
    """

    def __init__(self, market: Market, domains: Dict[int, List[int]],
                 power_cap: float, target_util: float = 0.8,
                 cfg: Optional[InfraMapConfig] = None) -> None:
        super().__init__(market, cfg)
        self.domains = domains          # domain node -> leaf/topology nodes
        self.power_cap = power_cap
        self.target = target_util
        self.floors: Dict[int, float] = {}

    def observe(self, now: float, power_by_domain: Dict[int, float]) -> None:
        for dom, used in power_by_domain.items():
            overuse = max(0.0, used / self.power_cap - self.target)
            floor = self.cfg.base_price * (1.0 + self.cfg.power_coeff
                                           * overuse)
            self.floors[dom] = floor
            self.market.set_floor(dom, floor)


class MaintenanceInfraMap(InfraMap):
    """Schedule a maintenance window on a subtree: reclaim pressure by
    price, so tenants drain themselves instead of being hard-preempted."""

    def __init__(self, market: Market,
                 cfg: Optional[InfraMapConfig] = None) -> None:
        super().__init__(market, cfg)
        self.windows: List = []   # (node, t_start, t_end)

    def schedule(self, node: int, t_start: float, t_end: float) -> None:
        self.windows.append((node, t_start, t_end))

    def step(self, now: float, nodes: Optional[List[int]] = None) -> None:
        self.market.advance_to(now)
        for node, t0, t1 in self.windows:
            if t0 <= now < t1:
                self.market.set_floor(node, self.cfg.maintenance_price)
            elif now >= t1:
                self.market.set_floor(node, self.cfg.base_price)
