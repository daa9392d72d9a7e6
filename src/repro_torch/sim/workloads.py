"""Tenant workload parameters, copied from ``repro.sim.workloads`` and
trimmed to what the fleet reads: the fleet keeps every tenant's dynamics
as arrays (``sim/fleet.py``) and is locality-free, so ``Tenant`` here
only carries the parameters, the arrival time and the overhead
multiplier."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

# on-demand $/h anchors [34]
ON_DEMAND = {"H100": 4.76, "A100": 3.67}
# dense kind codes of the vectorized fleet
KIND_IDS = {"training": 0, "inference": 1, "batch": 2}


@dataclass
class WorkloadParams:
    kind: str                       # "training" | "inference" | "batch"
    work: float = 0.0               # H100-hours to finish (train/batch)
    deadline_s: float = 7200.0
    checkpoint_interval_s: float = 300.0
    reconfig_s: float = 120.0       # base reconfiguration overhead
    max_nodes: int = 8
    # inference-only
    rate_fn: Optional[Callable[[float], float]] = None
    cap_per_node: float = 10.0      # requests/s a node can serve
    sla_value_per_h: float = 40.0   # service fee exposed to SLA credits
    # value model
    value_per_gap: float = 20.0     # $/h per unit utility gap


class Tenant:
    """A tenant's parameters as the fleet reads them."""

    def __init__(self, name: str, params: WorkloadParams,
                 arrival_s: float = 0.0,
                 overhead_mult: float = 1.0) -> None:
        self.name = name
        self.p = params
        self.arrival_s = arrival_s
        self.overhead_mult = overhead_mult
