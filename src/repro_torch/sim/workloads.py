"""Tenant workloads: LLM inference (Dynamo-planner-style), DNN training
(Sailor-style, topology-sensitive), batch analytics (Parabricks-style).

One ``Tenant`` class models progress, reconfiguration overheads, deadlines
and SLO penalties; per-class parameters instantiate the three families from
paper Table 1. The same tenant logic runs under every cloud interface
(LaissezCloud / FCFS / FCFS-P) — only the acquisition mechanism differs —
matching the paper's "to isolate the effect of the cloud interface" setup.

The tenant also implements the EconAdapter AppHooks (paper Listing 1):
profiled marginal utility, utility gap, value per utility gap,
checkpoint-timing reconfiguration costs.

Copied from ``repro.sim.workloads``; the vectorized fleet
(``sim/fleet.py``) reads the parameters of these tenants as arrays.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.core.market import Market
from repro_torch.core.topology import Topology

# per-GPU relative throughput (H100-equivalents), public benchmark ballpark
GPU_SPEED = {"H100": 1.0, "A100": 0.45}
# on-demand $/h anchors [34]
ON_DEMAND = {"H100": 4.76, "A100": 3.67}
# dense kind codes shared with the vectorized fleet (sim/fleet.py keeps
# one int32 array column per tenant instead of the string kind)
KIND_IDS = {"training": 0, "inference": 1, "batch": 2}


@dataclass
class WorkloadParams:
    kind: str                       # "training" | "inference" | "batch"
    work: float = 0.0               # H100-hours to finish (train/batch)
    deadline_s: float = 7200.0
    checkpoint_interval_s: float = 300.0
    reconfig_s: float = 120.0       # base reconfiguration overhead
    max_nodes: int = 8
    compat: Sequence[str] = ("H100", "A100")
    topology_sensitive: bool = False
    locality_penalty: float = 0.5   # throughput multiplier when scattered
    # inference-only
    rate_fn: Optional[Callable[[float], float]] = None
    cap_per_node: float = 10.0      # requests/s a node can serve
    sla_value_per_h: float = 40.0   # service fee exposed to SLA credits
    # value model
    value_per_gap: float = 20.0     # $/h per unit utility gap


class Tenant:
    """Workload state machine + AppHooks implementation."""

    def __init__(self, name: str, params: WorkloadParams, topo: Topology,
                 arrival_s: float = 0.0,
                 overhead_mult: float = 1.0) -> None:
        self.name = name
        self.p = params
        self.topo = topo
        self.arrival_s = arrival_s
        self.overhead_mult = overhead_mult
        self.nodes: Set[int] = set()          # currently held leaves
        self.progress = 0.0                   # H100-hours completed
        self.served = 0.0                     # inference: served req-seconds
        self.demanded = 0.0                   # inference: offered load
        self.reconfig_until = -1.0
        self.last_checkpoint = arrival_s
        self.last_t = arrival_s
        self.done_at: Optional[float] = None
        self.cost = 0.0                       # for non-market clouds
        self._rate_ewma = 0.0                 # smoothed inference load
        self._last_scale_down = arrival_s
        # inference cold-start batch: newly granted replicas warm up for
        # reconfig_s while the rest of the fleet keeps serving (stateless
        # serving never stalls globally; see docs/DESIGN.md §13 audit A1).
        # Grants inside an open warm-up window merge into one batch.
        self._cold_cnt = 0
        self._cold_until = -1.0
        # charged rates per owned leaf, refreshed by the EconAdapter each
        # step (clouds without price signals leave this empty)
        self.current_rates: Dict[int, float] = {}

    # ------------------------------------------------------------ helpers
    def attach(self, market: Market) -> "Tenant":
        """Wire market transfers to this tenant's grant/revoke callbacks
        (sim/cloud.LaissezCloud does this for full scenarios; standalone
        EconAdapter users call attach() directly)."""
        def cb(now, leaf, old, new, rate, reason):
            if old == self.name:
                self.on_revoke(leaf, now, graceful=(reason == "explicit"))
            if new == self.name:
                self.on_grant(leaf, now)
        market.on_transfer.append(cb)
        return self

    def gpu_type(self, leaf: int) -> str:
        return self.topo.node(leaf).rtype

    def node_speed(self, leaf: int) -> float:
        return GPU_SPEED.get(self.gpu_type(leaf), 1.0)

    def _locality_factor(self) -> float:
        """Training throughput bonus for co-located nodes (Fig 10): full
        speed if all nodes share a host/rack scale-up domain."""
        if not self.p.topology_sensitive or len(self.nodes) <= 1:
            return 1.0
        it = iter(self.nodes)
        scope = self.topo.ancestors(next(it))
        hosts = {scope[1] if len(scope) > 1 else scope[0]}
        racks = {scope[2] if len(scope) > 2 else scope[0]}
        for leaf in it:
            anc = self.topo.ancestors(leaf)
            hosts.add(anc[1] if len(anc) > 1 else anc[0])
            racks.add(anc[2] if len(anc) > 2 else anc[0])
        if len(hosts) == 1:
            return 1.0
        if len(racks) == 1:
            return 1.0 - (1.0 - self.p.locality_penalty) * 0.5
        return self.p.locality_penalty

    def throughput(self) -> float:
        """Current H100-equivalents of useful compute."""
        base = sum(self.node_speed(l) for l in self.nodes)
        return base * self._locality_factor()

    def capacity_rps(self) -> float:
        return sum(self.node_speed(l) for l in self.nodes) \
            * self.p.cap_per_node

    # ------------------------------------------------------------ dynamics
    def advance(self, now: float) -> None:
        dt = now - self.last_t
        if dt <= 0:
            return
        self.last_t = now
        if now < self.arrival_s or self.done_at is not None:
            return
        active_dt = dt
        if now <= self.reconfig_until:
            active_dt = 0.0
        elif self.reconfig_until > now - dt:
            active_dt = now - self.reconfig_until
        if self.p.kind == "inference":
            lam = self.p.rate_fn(now) if self.p.rate_fn else 0.0
            alpha = min(1.0, dt / 300.0)      # ~5 min planner smoothing
            self._rate_ewma += alpha * (lam - self._rate_ewma)
            self.demanded += lam * dt
            # cold replicas serve only for the tail of the tick past their
            # warm-up deadline; warm replicas serve the full tick
            n_nodes = len(self.nodes)
            cold_frac = min(1.0, max(0.0, (now - self._cold_until) / dt))
            share = self._cold_cnt / n_nodes if n_nodes else 0.0
            eff_cap = self.capacity_rps() * (1.0 - share * (1.0 - cold_frac))
            self.served += min(lam, eff_cap) * dt
            if now >= self._cold_until:
                self._cold_cnt = 0
        else:
            self.progress += self.throughput() * active_dt / 3600.0
            if now - self.last_checkpoint >= self.p.checkpoint_interval_s:
                self.last_checkpoint = now
            if self.progress >= self.p.work and self.done_at is None:
                self.done_at = now

    def on_grant(self, leaf: int, now: float) -> None:
        self.nodes.add(leaf)
        if self.p.kind == "inference":
            self._cold_mature(now)
            self._cold_cnt += 1
            self._cold_until = now + self.p.reconfig_s * self.overhead_mult
        else:
            self._reconfigure(now, shrink=False)

    def on_revoke(self, leaf: int, now: float, *,
                  graceful: bool = False) -> None:
        self.nodes.discard(leaf)
        if self.p.kind == "inference":
            # stateless serving: losing a replica costs capacity only —
            # no checkpoint waste, no global stall
            self._cold_mature(now)
            self._cold_cnt = min(self._cold_cnt, len(self.nodes))
            return
        if not graceful:
            # involuntary revocation wastes work since the last checkpoint
            waste_s = min(now - self.last_checkpoint,
                          self.p.checkpoint_interval_s)
            lost = self.throughput() * waste_s / 3600.0
            self.progress = max(0.0, self.progress - lost)
        self._reconfigure(now, shrink=True)

    def _cold_mature(self, now: float) -> None:
        if now >= self._cold_until:
            self._cold_cnt = 0

    def _reconfigure(self, now: float, shrink: bool) -> None:
        if self.done_at is not None:
            return
        # restart absorption (audit A3): membership changes landing
        # while a restart is already in flight fold into it — elastic
        # trainers coalesce scale events into one restart rather than
        # restarting per node, else trickle-in grants stall the job
        # forever (docs/DESIGN.md §13)
        if now <= self.reconfig_until:
            return
        overhead = self.p.reconfig_s * self.overhead_mult
        self.reconfig_until = now + overhead

    # ------------------------------------------------------------ metrics
    def performance(self, now: float) -> float:
        """Paper §5.1: inference = fraction of objective achieved;
        train/batch = normalized progress toward the deadline."""
        if self.p.kind == "inference":
            return self.served / self.demanded if self.demanded > 0 else 1.0
        end = self.arrival_s + self.deadline_remaining_total()
        expected = self.p.work * min(
            1.0, max(now - self.arrival_s, 1e-9)
            / max(self.p.deadline_s, 1e-9))
        if self.done_at is not None:
            return 1.0
        return min(1.0, self.progress / expected) if expected > 0 else 1.0

    def deadline_remaining_total(self) -> float:
        return self.p.deadline_s

    # ------------------------------------------------------------ autoscaler
    def desired_nodes(self, now: float) -> int:
        """Shared autoscaler (identical across cloud interfaces)."""
        if now < self.arrival_s or self.done_at is not None:
            return 0
        if self.p.kind == "inference":
            lam = self.p.rate_fn(now) if self.p.rate_fn else 0.0
            plan = max(self._rate_ewma, 0.7 * lam)   # smoothed + peak guard
            return min(self.p.max_nodes,
                       int(math.ceil(plan / self.p.cap_per_node)))
        # uniform progress [47]: pace so remaining work / remaining time
        remaining = max(self.p.work - self.progress, 0.0)
        t_left = max(self.arrival_s + self.p.deadline_s - now, 1.0)
        need = remaining / (t_left / 3600.0)       # H100-equivalents needed
        return min(self.p.max_nodes, max(0, int(math.ceil(need))))

    def dominant_host(self) -> Optional[int]:
        """Host (scale-up domain) holding most of this tenant's nodes."""
        if not self.nodes:
            return None
        counts: Dict[int, int] = {}
        for l in self.nodes:
            anc = self.topo.ancestors(l)
            h = anc[1] if len(anc) > 1 else anc[0]
            counts[h] = counts.get(h, 0) + 1
        return max(counts, key=counts.get)

    def effective_speed(self, leaf: int) -> float:
        """Per-node contribution, locality-adjusted for training."""
        s = self.node_speed(leaf)
        if self.p.topology_sensitive and len(self.nodes) > 1:
            dom = self.dominant_host()
            anc = self.topo.ancestors(leaf)
            h = anc[1] if len(anc) > 1 else anc[0]
            if h != dom:
                s *= self.p.locality_penalty
        return s

    def _surplus(self, now: float) -> List[int]:
        """Pure view: lowest value-per-dollar nodes beyond current need."""
        want = self.desired_nodes(now)
        extra = len(self.nodes) - want
        if extra <= 0:
            return []

        def key(l):
            rate = max(self.current_rates.get(l, 1.0), 1e-6)
            return self.effective_speed(l) / rate
        ranked = sorted(self.nodes, key=key)
        return ranked[:extra]

    def surplus_nodes(self, now: float) -> List[int]:
        """Committing variant with 120 s scale-down hysteresis (avoids
        grant/release thrash); shared across all cloud interfaces.
        (Longer, overhead-proportional holds were tried and measured WORSE
        — held surplus starves other tenants more than churn costs.)"""
        if now - self._last_scale_down < 120.0:
            return []
        out = self._surplus(now)
        if out:
            self._last_scale_down = now
        return out

    # ------------------------------------------------ EconAdapter AppHooks
    def _planned_rate(self) -> float:
        """The planner's smoothed demand (same signal desired_nodes
        uses) — pricing off the instantaneous noisy rate makes bid
        orderings flip every epoch and churns warm replicas (audit A3)."""
        lam = self.p.rate_fn(self.last_t) if self.p.rate_fn else 0.0
        return max(self._rate_ewma, 0.7 * lam)

    def profiled_marginal_utility(self, leaf: int, goal: str) -> float:
        """Utility units: fraction of objective per hour contributed."""
        if self.p.kind == "inference":
            plan = self._planned_rate()
            if plan <= 0:
                return 0.0
            marginal = min(self.node_speed(leaf) * self.p.cap_per_node,
                           plan)
            return marginal / plan
        speed = self.node_speed(leaf)
        if self.p.topology_sensitive and self.nodes:
            anc = set(self.topo.ancestors(leaf))
            same_host = any(
                self.topo.ancestors(l)[1] in anc for l in self.nodes)
            if not same_host:
                speed *= self.p.locality_penalty
        remaining = max(self.p.work - self.progress, 1e-9)
        return min(1.0, speed / remaining)

    def current_utility_gap(self) -> float:
        if self.p.kind == "inference":
            plan = self._planned_rate()
            if plan <= 0:
                return 0.0
            return max(0.0, 1.0 - self.capacity_rps() / plan)
        t_left = max(self.arrival_s + self.p.deadline_s - self.last_t, 1.0)
        need = max(self.p.work - self.progress, 0.0) / (t_left / 3600.0)
        have = self.throughput()
        return max(0.0, (need - have) / max(need, 1e-9))

    def value_per_utility_gap(self) -> float:
        # convex escalation: a tenant falling behind its objective values
        # marginal capacity more (the paper's "urgent tenants raise bids
        # and reclaim resources from lower-value uses", §5.2)
        urgency = 1.0 + 2.0 * self.current_utility_gap()
        if self.p.kind == "inference":
            # Microsoft online-services SLA: P99 -> 10%, P999 -> 25% credits
            return self.p.sla_value_per_h * (0.10 + 0.25) * urgency
        return self.p.value_per_gap * urgency

    def node_redundant(self, leaf: int) -> bool:
        return leaf in self._surplus(self.last_t)   # non-committing peek

    def gang_size(self) -> int:
        """How many held nodes a membership change stalls (Listing-1
        switching-cost scaling): the whole job for gang-scheduled
        train/batch, none for independently-warming inference replicas."""
        if self.p.kind == "inference":
            return 0
        return len(self.nodes)

    def cold_start_time(self, leaf: int) -> float:
        return self.p.reconfig_s

    def time_since_chkpt(self, leaf: int) -> float:
        # stateless inference has no at-risk work between checkpoints;
        # pricing it as if it did inflates retention limits without bound
        # (last_checkpoint never advances for inference) — audit A2
        if self.p.kind == "inference":
            return 0.0
        return self.last_t - self.last_checkpoint

    def time_till_chkpt(self, leaf: int) -> float:
        if self.p.kind == "inference":
            return 0.0
        return max(0.0, self.p.checkpoint_interval_s
                   - (self.last_t - self.last_checkpoint))

    def desired_scopes(self, market: Market) -> List[int]:
        """Scoped wants: topology-sensitive tenants target the scale-up
        domain of nodes they already own (paper §4.3); others bid at type
        roots. Returns one scope per node wanted."""
        want = self.desired_nodes(self.last_t) - len(self.nodes)
        if want <= 0:
            return []
        scopes: List[int] = []
        roots = [market.topo.roots[t] for t in self.p.compat
                 if t in market.topo.roots]
        for i in range(want):
            if (self.p.topology_sensitive and self.nodes):
                anc = self.topo.ancestors(next(iter(self.nodes)))
                # same host first, else same rack
                scopes.append(anc[1] if len(anc) > 1 else anc[0])
            elif roots:
                scopes.append(roots[i % len(roots)])
        return scopes
