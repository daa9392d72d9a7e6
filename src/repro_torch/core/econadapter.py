"""EconAdapter: tenant-side translation of application utility into market
actions (paper §4.5, Listing 1), copied from ``repro.core.econadapter``.

The application/autoscaler supplies the hooks that modern systems already
maintain (utility gap, marginal utility, penalty model, reconfiguration
overheads); the adapter turns them into bids, retention limits and
relinquish decisions.  The pricing formula mirrors paper Listing 1:

    marginal_utility = APP.profiled_marginal_utility(n, gs)
    monetary_value   = APP.value_per_utility_gap() * marginal_utility
    if APP.node_redundant(n): return monetary_value          # ~0
    reconf = APP.cold_start_time(n)
    if gs == GROW:   reconf += APP.time_since_chkpt(n)   # restart waste
    if gs == SHRINK: reconf += APP.time_till_chkpt(n)    # drain cost
    return monetary_value - reconf * market_rate / horizon

Note on units: the listing subtracts a *stock* (wasted $ = reconf_time x
market price) from a *flow* ($/h bid).  We amortize the stock over the
adapter's decision horizon (default 1 h) to keep the bid in $/h; the
paper's listing elides this conversion.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Sequence

from repro_torch.core.market import Market

GROW = "GROW"
SHRINK = "SHRINK"


class AppHooks(Protocol):
    """What the application runtime / autoscaler must expose (Table 2:
    17-55 LoC per system in the paper; our sim tenants implement these)."""

    def profiled_marginal_utility(self, leaf: int, goal: str) -> float: ...
    def current_utility_gap(self) -> float: ...
    def value_per_utility_gap(self) -> float: ...
    def node_redundant(self, leaf: int) -> bool: ...
    def cold_start_time(self, leaf: int) -> float: ...
    def time_since_chkpt(self, leaf: int) -> float: ...
    def time_till_chkpt(self, leaf: int) -> float: ...
    def desired_scopes(self, market: Market) -> Sequence[int]: ...


@dataclass
class AdapterConfig:
    horizon_h: float = 1.0           # amortization horizon for reconf waste
    budget_rate: float = math.inf    # max total $/h spend
    topology_aware: bool = True      # Fig 10 toggle
    reconfig_estimate_mult: float = 1.0   # Fig 15 misestimation knob
    max_orders: int = 64


class EconAdapter:
    """Drives one tenant's market presence from its app hooks."""

    def __init__(self, market: Market, tenant: str, app: AppHooks,
                 cfg: Optional[AdapterConfig] = None) -> None:
        self.market = market
        self.tenant = tenant
        self.app = app
        self.cfg = cfg or AdapterConfig()
        self._open_orders: Dict[int, int] = {}   # order_id -> scope
        self._last_exchange = -1e18

    # --- paper Listing 1 ---------------------------------------------------
    def _stall_burn(self, monetary_value: float, rate: float) -> float:
        """$-per-hour burned while a membership change is in flight: rent
        on the moving node, plus — for gang-scheduled apps, which restart
        as a whole (``gang_size`` hook) — rent AND foregone utility on
        every stalled peer.  This is exactly the waste the workload model
        charges (global reconfig stall + checkpoint loss over
        ``throughput()``), so pricing anything less understates switching
        costs and churns the market (audit A3, docs/DESIGN.md §13).  The
        moving node itself counts too: it produces nothing while it
        warms up / restarts wherever it lands."""
        gang = getattr(self.app, "gang_size", lambda: 0)()
        return (gang + 1) * (monetary_value + rate)

    def price(self, leaf: int, goal: str, market_rate: float) -> float:
        app = self.app
        mu = app.profiled_marginal_utility(leaf, goal)
        monetary_value = app.value_per_utility_gap() * mu
        if app.node_redundant(leaf):
            return monetary_value
        reconf_s = app.cold_start_time(leaf)
        if goal == GROW:
            reconf_s += app.time_since_chkpt(leaf)
        elif goal == SHRINK:
            reconf_s += app.time_till_chkpt(leaf)
        reconf_s *= self.cfg.reconfig_estimate_mult
        waste = (reconf_s / 3600.0) \
            * self._stall_burn(monetary_value, market_rate)
        return monetary_value - waste / max(self.cfg.horizon_h, 1e-9)

    def retention_limit(self, leaf: int, market_rate: float) -> float:
        """What involuntary eviction costs right now: the node's value PLUS
        the work at risk since the last checkpoint (paper Fig 2 — the limit
        falls right after a checkpoint, when migration is cheap, and rises
        through the epoch)."""
        app = self.app
        mu = app.profiled_marginal_utility(leaf, SHRINK)
        value = app.value_per_utility_gap() * mu
        at_risk_s = (app.cold_start_time(leaf)
                     + app.time_since_chkpt(leaf)) \
            * self.cfg.reconfig_estimate_mult
        waste = (at_risk_s / 3600.0) \
            * self._stall_burn(value, max(market_rate, 1e-6))
        return value + waste / max(self.cfg.horizon_h, 1e-9)

    # --- periodic policy -----------------------------------------------------
    def step(self, now: float) -> None:
        m = self.market
        m.advance_to(now)
        self._sync_orders()
        # 0) publish charged rates to the app (value-per-dollar pruning)
        rates = {leaf: m.market_rate(leaf)
                 for leaf in m.owned_leaves(self.tenant)}
        if hasattr(self.app, "current_rates"):
            self.app.current_rates = rates
        # 1) retention limits on owned resources: what holding is worth;
        #    prune surplus once per step (lowest value-per-dollar first)
        surplus = set(getattr(self.app, "surplus_nodes",
                              lambda t: [])(now))
        spend = 0.0
        for leaf in sorted(rates):
            rate = rates[leaf]
            if leaf in surplus:
                m.relinquish(self.tenant, leaf)
                continue
            m.set_retention_limit(self.tenant, leaf,
                                  self.retention_limit(leaf, rate))
            spend += rate
        # 2) grow orders toward the app's desired scopes, budget-capped.
        #    A tenant mid-reconfiguration can't productively absorb new
        #    nodes yet — bidding anyway fuels eviction cycles (urgency
        #    rises after every loss, the re-bid evicts the evictor, both
        #    sides burn reconfig stalls). Sit the window out instead.
        if now <= getattr(self.app, "reconfig_until", -math.inf):
            scopes: List[int] = []
        else:
            scopes = list(self.app.desired_scopes(m))
        if not self.cfg.topology_aware:
            scopes = [self.market.topo.ancestors(s)[-1] for s in scopes]
        budget_left = self.cfg.budget_rate - spend
        self._place_scoped(scopes, budget_left)
        # 3) exchange moves: the paper's continuous-renegotiation upside.
        self._exchange_orders(now, rates, budget_left)

    def _place_scoped(self, scopes, budget_left: float) -> None:
        m = self.market
        for scope in scopes[:self.cfg.max_orders]:
            try:
                ref = m.query_price(self.tenant, scope,
                                    enforce_visibility=False)
            except Exception:
                ref = 0.0
            ref = 0.0 if math.isinf(ref) else ref
            bid = self.price(next(iter(m.topo.leaves_of(scope))), GROW, ref)
            bid = min(bid, budget_left)
            if bid <= 0:
                continue
            oid = m.place_order(self.tenant, scope, bid, limit=bid)
            if m.orders[oid].active:
                self._open_orders[oid] = scope
            budget_left -= bid

    def _exchange_orders(self, now: float, rates, budget_left) -> None:
        """(a) locality exchange: bid for a node in the dominant scale-up
        domain when the current placement is scattered (Fig 10); (b) cost
        exchange: bid for a cheaper compatible node when an owned one's
        charged rate exceeds the cheapest alternative by more than the
        amortized switching cost (Figs 7/11). Winning either makes some
        owned node redundant; step (1) prunes it next tick."""
        m = self.market
        app = self.app
        owned = sorted(rates)
        if not owned:
            return
        # don't stack exchanges while a prune is pending
        if getattr(app, "desired_nodes", None) is not None \
                and len(owned) > app.desired_nodes(now):
            return
        # exchange cooldown: switching faster than the reconfiguration
        # overhead amortizes is always a losing trade (churn guard)
        cooldown = max(600.0, 3.0 * app.cold_start_time(owned[0]))
        if now - self._last_exchange < cooldown:
            return
        # (a) locality
        if (self.cfg.topology_aware
                and getattr(app, "dominant_host", None)
                and getattr(app.p, "topology_sensitive", False)
                and len(owned) > 1):
            dom = app.dominant_host()
            scattered = [l for l in owned
                         if (m.topo.ancestors(l)[1]
                             if len(m.topo.ancestors(l)) > 1
                             else m.topo.ancestors(l)[0]) != dom]
            if scattered and dom is not None:
                ref = rates[scattered[0]]
                bid = self.price(m.topo.leaves_of(dom)[0], GROW, ref)
                bid = min(bid, budget_left)
                if bid > 0:
                    oid = m.place_order(self.tenant, dom, bid, limit=bid)
                    if m.orders[oid].active:
                        self._open_orders[oid] = dom
                    self._last_exchange = now
                    return          # one exchange move per step
        # (b) cost: trade toward better VALUE PER DOLLAR (not raw price —
        # a cheaper-but-slower node can be a losing trade), with a 15%
        # margin plus the amortized switching cost as hysteresis
        roots = [m.topo.roots[t] for t in getattr(app.p, "compat", ())
                 if t in m.topo.roots]
        if not roots:
            return
        eff = getattr(app, "effective_speed", app.node_speed)
        value = app.value_per_utility_gap()
        worst = min(owned,
                    key=lambda l: eff(l) / max(rates[l], 1e-6))
        # net hourly surplus of keeping the worst node ($/h units)
        mu_w = app.profiled_marginal_utility(worst, SHRINK)
        net_worst = value * mu_w - rates[worst]
        # a freshly-acquired root-scoped node lands scattered: value it
        # with the locality penalty a topology-sensitive app would pay
        pen = app.p.locality_penalty \
            if getattr(app.p, "topology_sensitive", False) else 1.0
        best = None
        for r in roots:
            try:
                p = m.query_price(self.tenant, r)
            except Exception:
                continue
            if math.isinf(p) or p <= 0:
                continue
            mu_a = app.profiled_marginal_utility(
                m.topo.leaves_of(r)[0], GROW) * pen
            net = value * mu_a - p
            if best is None or net > best[0]:
                best = (net, p, r)
        if best is None:
            return
        net_alt, alt_price, alt_root = best
        switch_cost = ((app.cold_start_time(worst)
                        + app.time_since_chkpt(worst))
                       * self.cfg.reconfig_estimate_mult / 3600.0) \
            * rates[worst] / max(self.cfg.horizon_h, 1e-9)
        # exchange only if the $/h surplus strictly improves after the
        # amortized switching waste (same-unit comparison)
        if net_alt - switch_cost > net_worst + 1e-6:
            bid = min(alt_price * 1.05 + 1e-3, budget_left)
            if bid > 0:
                oid = m.place_order(self.tenant, alt_root, bid, limit=bid)
                if m.orders[oid].active:
                    self._open_orders[oid] = alt_root
                self._last_exchange = now

    def _sync_orders(self) -> None:
        """Drop consumed orders; cancel stale ones (fresh each step)."""
        for oid in list(self._open_orders):
            o = self.market.orders.get(oid)
            if o is None or not o.active:
                del self._open_orders[oid]
            else:
                self.market.cancel_order(self.tenant, oid)
                del self._open_orders[oid]

    def shutdown(self) -> None:
        self._sync_orders()
        for leaf in list(self.market.owned_leaves(self.tenant)):
            self.market.relinquish(self.tenant, leaf)
