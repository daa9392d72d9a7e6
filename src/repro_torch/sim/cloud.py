"""Cloud allocation interfaces, copied from ``repro.sim.cloud``:
LaissezCloud and the paper's baselines.

All clouds expose the same surface to tenants (grant/revoke callbacks, a
step() driven by the shared autoscaler), so the only difference between
runs is the cloud-side allocation contract — continuous negotiation
(LaissezCloud, on the event ``Market``; LaissezBatchCloud, on the batch
engine's facade), static allocation (FCFS), operator-favoured preemption
(FCFS-P), or a spot market with launch-time bids and unilateral
preemption (SpotCloud; its ``SpotBook`` is also what the fleet-scale
spot baseline in ``sim/fleet_baselines.py`` drives).  See
docs/DESIGN.md §13 for the baseline catalog.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.econadapter import GROW, AdapterConfig, EconAdapter
from repro_torch.core.market import Market, VolatilityControls
from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim.workloads import ON_DEMAND, Tenant


class CloudBase:
    def __init__(self, topo: Topology) -> None:
        self.topo = topo
        self.tenants: Dict[str, Tenant] = {}

    def add_tenant(self, tenant: Tenant, **kw) -> None:
        self.tenants[tenant.name] = tenant

    def step(self, now: float) -> None:
        raise NotImplementedError

    def cost_of(self, name: str) -> float:
        raise NotImplementedError

    # helpers shared by the non-market clouds ------------------------------
    def _free_leaves(self, owned: Dict[int, Optional[str]],
                     compat: Sequence[str]) -> List[int]:
        out = []
        for rtype in compat:
            root = self.topo.roots.get(rtype)
            if root is None:
                continue
            out.extend(l for l in self.topo.leaves_of(root)
                       if owned.get(l) is None)
        return out


# ---------------------------------------------------------------------------
# FCFS: requests allocate in arrival order; tenants wait if HW is occupied.
# ---------------------------------------------------------------------------
class FCFSCloud(CloudBase):
    preemptive = False

    def __init__(self, topo: Topology) -> None:
        super().__init__(topo)
        self.owner: Dict[int, Optional[str]] = {
            n.node_id: None for n in topo.nodes if n.is_leaf}
        self.queue: Deque[Tuple[str]] = deque()
        self.costs: Dict[str, float] = {}
        self.last_t = 0.0

    def _bill(self, now: float) -> None:
        dt_h = (now - self.last_t) / 3600.0
        if dt_h > 0:
            for leaf, owner in self.owner.items():
                if owner is not None:
                    self.costs[owner] = self.costs.get(owner, 0.0) \
                        + ON_DEMAND[self.topo.node(leaf).rtype] * dt_h
        self.last_t = now

    def _grant(self, tenant: Tenant, leaf: int, now: float) -> None:
        self.owner[leaf] = tenant.name
        tenant.on_grant(leaf, now)

    def _revoke(self, tenant: Tenant, leaf: int, now: float,
                graceful: bool) -> None:
        self.owner[leaf] = None
        tenant.on_revoke(leaf, now, graceful=graceful)

    def step(self, now: float) -> None:
        self._bill(now)
        # releases first (shared pruning policy)
        for t in self.tenants.values():
            for leaf in t.surplus_nodes(now):
                self._revoke(t, leaf, now, graceful=True)
        # then queue wants in arrival order
        for t in sorted(self.tenants.values(), key=lambda x: x.arrival_s):
            want = t.desired_nodes(now) - len(t.nodes)
            if want <= 0:
                continue
            free = self._free_leaves(self.owner, t.p.compat)
            # prefer faster hardware first (greedy; both baselines do this)
            free.sort(key=lambda l: -1.0 if self.topo.node(l).rtype == "H100"
                      else 0.0)
            for leaf in free[:want]:
                self._grant(t, leaf, now)
            want -= min(want, len(free))
            if want > 0 and self.preemptive:
                self._preempt(t, want, now)

    def _preempt(self, t: Tenant, want: int, now: float) -> None:
        pass

    def cost_of(self, name: str) -> float:
        return self.costs.get(name, 0.0)


# ---------------------------------------------------------------------------
# FCFS-P: inference tenants preempt training/batch, spot-style (coarse
# victim choice, unilateral revocation — the paper's §2.2 FCFS-P).
# ---------------------------------------------------------------------------
class FCFSPCloud(FCFSCloud):
    preemptive = True

    def _preempt(self, t: Tenant, want: int, now: float) -> None:
        if t.p.kind != "inference":
            return
        # spot-style: the operator sees only "preemptible", not current
        # inconvenience — coarse victim choice (paper §2.1), but rate-
        # limited like real spot reclaim (not every scheduler tick)
        if now - getattr(t, "_last_preempt", -1e9) < 120.0:
            return
        t._last_preempt = now
        victims: List[Tuple[int, Tenant]] = []
        for leaf, owner in self.owner.items():
            if owner is None:
                continue
            vt = self.tenants[owner]
            if vt.p.kind in ("training", "batch") \
                    and self.topo.node(leaf).rtype in t.p.compat:
                victims.append((leaf, vt))
        for leaf, vt in victims[:want]:
            self._revoke(vt, leaf, now, graceful=False)  # wastes work
            self._grant(t, leaf, now)


# ---------------------------------------------------------------------------
# Spot: launch-time bids, marginal-demand clearing, unilateral preemption
# (Voorsluys et al. spot provisioning; CloudSim Plus marketspace — PAPERS.md).
# ---------------------------------------------------------------------------
@dataclass
class SpotRequest:
    seq: int
    tenant: str
    bid: float            # frozen at request time, never renegotiated


class SpotBook:
    """Single-resource-type spot market core: launch-bid book, clearing
    price, reclamation notices.  Pure state machine (no Tenant
    callbacks), so a test can drive it directly.

    Semantics:

    * the spot price is the **clearing price of marginal demand**: with
      all standing bids (held leaves at their launch bids + open
      requests) sorted descending over capacity C, the price is the
      highest *rejected* bid, or the reserve ``floor`` when demand fits;
    * a held leaf whose launch bid is under the spot price gets a
      reclamation notice ``notice_s`` ahead; at expiry it is revoked iff
      the price still exceeds its bid (a dip back under the bid rescinds
      the notice) — so preemption fires iff spot > launch bid;
    * winners pay ``min(spot, bid)`` — bills never exceed the bid rate;
    * requests are **one-shot** (AWS one-time spot requests): whatever
      does not fill in a clearing expires at its end, so demand is
      re-quoted at the next step's conditions.  Only *launched*
      instances keep their bid frozen — that frozen launch bid, never
      renegotiated, is the interface difference vs laissez-faire.
    """

    def __init__(self, leaves: Sequence[int], floor: float,
                 notice_s: float = 120.0) -> None:
        self.leaves = list(leaves)
        self.floor = float(floor)
        self.notice_s = float(notice_s)
        self.owner: Dict[int, Optional[str]] = {l: None for l in self.leaves}
        self.launch_bid: Dict[int, float] = {}
        self.notice: Dict[int, float] = {}          # leaf -> deadline
        self.requests: List[SpotRequest] = []
        self.spot = self.floor
        self._seq = 0
        self.stats = {"requests": 0, "grants": 0, "preemptions": 0,
                      "notices": 0, "rescinded": 0, "expired": 0}

    # ------------------------------------------------------------- intake
    def request(self, tenant: str, bid: float) -> None:
        self.requests.append(SpotRequest(self._seq, tenant, float(bid)))
        self._seq += 1
        self.stats["requests"] += 1

    def cancel_newest(self, tenant: str, k: int) -> int:
        """Drop the tenant's k most recent open requests (demand fell)."""
        dropped = 0
        for i in range(len(self.requests) - 1, -1, -1):
            if dropped >= k:
                break
            if self.requests[i].tenant == tenant:
                del self.requests[i]
                dropped += 1
        return dropped

    def release(self, leaf: int) -> None:
        """Voluntary release by the holder."""
        self.owner[leaf] = None
        self.launch_bid.pop(leaf, None)
        self.notice.pop(leaf, None)

    def held(self, tenant: str) -> List[int]:
        return [l for l, o in self.owner.items() if o == tenant]

    def open_requests(self, tenant: str) -> int:
        return sum(1 for r in self.requests if r.tenant == tenant)

    # ----------------------------------------------------------- clearing
    def clear(self, now: float
              ) -> Tuple[List[Tuple[str, int, float]],
                         List[Tuple[str, int]]]:
        """One market step at ``now``: recompute the spot price, issue /
        rescind / fire reclamation notices, grant free leaves to winning
        requests.  Returns ``(grants, preempts)`` as
        ``[(tenant, leaf, bid)]`` / ``[(tenant, leaf)]``."""
        C = len(self.leaves)
        bids = sorted(
            [self.launch_bid[l] for l, o in self.owner.items()
             if o is not None] + [r.bid for r in self.requests],
            reverse=True)
        self.spot = max(self.floor, bids[C]) if len(bids) > C \
            else self.floor
        # notices: issue where the price overtook the launch bid, rescind
        # where it receded
        for leaf, own in self.owner.items():
            if own is None:
                continue
            if self.launch_bid[leaf] < self.spot - 1e-9:
                if leaf not in self.notice:
                    self.notice[leaf] = now + self.notice_s
                    self.stats["notices"] += 1
            elif self.notice.pop(leaf, None) is not None:
                self.stats["rescinded"] += 1
        preempts: List[Tuple[str, int]] = []
        for leaf, deadline in sorted(self.notice.items()):
            if deadline <= now:
                preempts.append((self.owner[leaf], leaf))
                self.owner[leaf] = None
                self.launch_bid.pop(leaf, None)
                del self.notice[leaf]
                self.stats["preemptions"] += 1
        # grants: highest bid first (ties by arrival seq) onto free leaves;
        # a request only clears at or above the current spot price
        free = sorted(l for l, o in self.owner.items() if o is None)
        grants: List[Tuple[str, int, float]] = []
        for r in sorted(self.requests, key=lambda r: (-r.bid, r.seq)):
            if not free:
                break
            if r.bid < self.spot - 1e-9 or r.bid < self.floor - 1e-9:
                continue
            leaf = free.pop(0)
            self.owner[leaf] = r.tenant
            self.launch_bid[leaf] = r.bid
            self.requests.remove(r)
            grants.append((r.tenant, leaf, r.bid))
            self.stats["grants"] += 1
        # one-shot requests: anything unfilled expires now.  A stale
        # frozen bid must not linger — it blocks the requester from
        # re-quoting at next step's urgency/price (observed as alone-run
        # starvation: a sub-floor bid pinned ``pending`` forever).
        self.stats["expired"] += len(self.requests)
        self.requests.clear()
        return grants, preempts

    def bill_rate(self, leaf: int) -> float:
        """Current $/h for a held leaf: the uniform clearing price,
        capped at the holder's launch bid."""
        return min(self.spot, self.launch_bid.get(leaf, self.spot))


class SpotCloud(CloudBase):
    """Spot-market baseline: one ``SpotBook`` per resource type over the
    shared topology.  Tenants attach a Listing-1 grow quote (against the
    current spot price, frozen at request time) to every node request;
    preempted leaves take the standard involuntary revocation/waste
    path."""

    notice_s = 120.0                 # reclamation notice window (AWS-ish)
    floor_frac = 0.7                 # reserve = 0.7x on-demand (laissez seed)

    def __init__(self, topo: Topology) -> None:
        super().__init__(topo)
        self.books: Dict[str, SpotBook] = {}
        for rtype, root in topo.roots.items():
            self.books[rtype] = SpotBook(
                topo.leaves_of(root),
                ON_DEMAND.get(rtype, 2.0) * self.floor_frac,
                self.notice_s)
        self._rtype_of = {l: rtype for rtype, b in self.books.items()
                          for l in b.leaves}
        self.quoters: Dict[str, EconAdapter] = {}
        self.costs: Dict[str, float] = {}
        self.last_t = 0.0

    def add_tenant(self, tenant: Tenant, **kw) -> None:
        super().add_tenant(tenant)
        # pro-forma adapter: only price() is used (pure app-hook math),
        # so the same Listing-1 quote rule prices spot launch bids —
        # what differs from laissez is ONLY that the bid is frozen
        self.quoters[tenant.name] = EconAdapter(None, tenant.name, tenant)

    # ------------------------------------------------------------- step
    def _bill(self, now: float) -> None:
        dt_h = (now - self.last_t) / 3600.0
        if dt_h > 0:
            for book in self.books.values():
                for leaf, owner in book.owner.items():
                    if owner is not None:
                        self.costs[owner] = self.costs.get(owner, 0.0) \
                            + book.bill_rate(leaf) * dt_h
        self.last_t = now

    def _books_for(self, tenant: Tenant) -> List[Tuple[str, SpotBook]]:
        """Compat books, cheapest spot first (ties prefer faster HW —
        compat order, matching the fcfs grant preference)."""
        pairs = [(rt, self.books[rt]) for rt in tenant.p.compat
                 if rt in self.books]
        return sorted(pairs, key=lambda p: p[1].spot)

    def _best_quote(self, t: Tenant) -> Optional[Tuple[SpotBook, float]]:
        """Quote every compat book and take the largest bid-over-spot
        headroom.  Raw cheapest-spot selection parks compute-hungry
        tenants on slow hardware whenever it is marginally cheaper; the
        Listing-1 quote already prices per-hardware marginal utility, so
        the spread against the book's price is the right ranking."""
        best, best_head = None, 0.0
        for _rt, book in self._books_for(t):
            bid = self.quoters[t.name].price(book.leaves[0], GROW,
                                             book.spot)
            if bid <= 0 or bid < book.floor - 1e-9:
                continue        # can never clear: spot >= floor always
            headroom = bid - book.spot
            if best is None or headroom > best_head:
                best, best_head = (book, bid), headroom
        return best

    def step(self, now: float) -> None:
        self._bill(now)
        # voluntary releases (shared pruning policy) + done-tenant drain
        for t in self.tenants.values():
            if t.done_at is not None:
                for rt, book in self.books.items():
                    for leaf in book.held(t.name):
                        book.release(leaf)
                        t.on_revoke(leaf, now, graceful=True)
                    book.cancel_newest(t.name, book.open_requests(t.name))
                continue
            for leaf in t.surplus_nodes(now):
                book = self.books[self._rtype_of[leaf]]
                book.release(leaf)
                t.on_revoke(leaf, now, graceful=True)
        # new requests in arrival order, bids frozen at request time.
        # Requests are one-shot (expire unfilled at end of this step's
        # clear), so there is no standing ``pending`` to subtract.
        for t in sorted(self.tenants.values(), key=lambda x: x.arrival_s):
            if now < t.arrival_s or t.done_at is not None:
                continue
            want = t.desired_nodes(now) - len(t.nodes)
            for _ in range(max(want, 0)):
                best = self._best_quote(t)
                if best is None:
                    break
                book, bid = best
                book.request(t.name, bid)
        # clear every book: preemptions (standard waste path), then grants
        for book in self.books.values():
            grants, preempts = book.clear(now)
            for owner, leaf in preempts:
                if owner in self.tenants:
                    self.tenants[owner].on_revoke(leaf, now,
                                                  graceful=False)
            for owner, leaf, _bid in grants:
                self.tenants[owner].on_grant(leaf, now)

    def cost_of(self, name: str) -> float:
        return self.costs.get(name, 0.0)

    @property
    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for book in self.books.values():
            for k, v in book.stats.items():
                out[k] = out.get(k, 0) + v
        return out


# ---------------------------------------------------------------------------
# LaissezCloud: tenants negotiate through the market via EconAdapters.
# ---------------------------------------------------------------------------
class LaissezCloud(CloudBase):
    def __init__(self, topo: Topology,
                 controls: Optional[VolatilityControls] = None,
                 base_prices: Optional[Dict[str, float]] = None) -> None:
        super().__init__(topo)
        self.market = self._make_market(topo, controls)
        # operator seeds the market: break-even floors (~0.7x on-demand)
        prices = base_prices or {t: ON_DEMAND.get(t, 2.0) * 0.7
                                 for t in topo.roots}
        for rtype, root in topo.roots.items():
            self.market.set_floor(root, prices.get(rtype, 1.0))
        self.adapters: Dict[str, EconAdapter] = {}
        self.market.on_transfer.append(self._on_transfer)

    def _make_market(self, topo: Topology, controls):
        return Market(topo, controls)

    def add_tenant(self, tenant: Tenant,
                   adapter_cfg: Optional[AdapterConfig] = None) -> None:
        super().add_tenant(tenant)
        self.adapters[tenant.name] = EconAdapter(
            self.market, tenant.name, tenant, adapter_cfg)

    def _on_transfer(self, now: float, leaf: int, old: str, new: str,
                     rate: float, reason: str) -> None:
        if old in self.tenants:
            # explicit relinquishment is the tenant's own (checkpoint-
            # timed) decision => no wasted work; limit crossings behave
            # like revocation (work since checkpoint is lost)
            self.tenants[old].on_revoke(leaf, now,
                                        graceful=(reason == "explicit"))
        if new in self.tenants:
            self.tenants[new].on_grant(leaf, now)

    def step(self, now: float) -> None:
        self.market.advance_to(now)
        for name in sorted(self.adapters):
            t = self.tenants[name]
            if now < t.arrival_s:
                continue
            if t.done_at is not None and t.nodes:
                self.adapters[name].shutdown()
                continue
            self.adapters[name].step(now)

    def cost_of(self, name: str) -> float:
        self.market.settle()
        return self.market.bills.get(name, 0.0)


# ---------------------------------------------------------------------------
# LaissezBatchCloud: the SAME negotiation contract, arbitrated by the
# PyTorch batch engine behind the Market-compatible facade —
# the paper's §5.5.1 scale path wired into the simulator end to end.
# ---------------------------------------------------------------------------
class LaissezBatchCloud(LaissezCloud):
    # sizing knobs, so bigger scenarios can grow the bid table, the
    # tenant table and the cascade width; the engine's device picks the
    # clearing pass (the CUDA kernel on the card, the plain version on
    # the CPU)
    capacity = 1 << 12
    n_tenants = 256
    k = 8

    def __init__(self, topo: Topology,
                 controls: Optional[VolatilityControls] = None,
                 base_prices: Optional[Dict[str, float]] = None,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        super().__init__(topo, controls, base_prices)

    def _make_market(self, topo: Topology, controls):
        from repro_torch.market_torch.bridge import BatchMarket
        return BatchMarket(topo, controls, capacity=self.capacity,
                           n_tenants=self.n_tenants, k=self.k,
                           device=self.device)
