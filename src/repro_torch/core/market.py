"""LaissezCloud matching engine, copied from ``repro.core.market``: the
event-driven ``Market`` (hierarchical order books with contestable
ownership, OCO scoped bids, retention limits, integral billing,
restricted price discovery and operator floor pricing, paper §4), its
records and the constants the batch engine and its facade share.  Host
Python, no tensors; the semantics are documented in the reference.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.topology import Topology

OPERATOR = "__operator__"
EPS = 1e-9
TICK = 1e-6


@dataclass
class Order:
    order_id: int
    tenant: str
    scope: int                 # topology node id
    price: float               # current resting bid rate ($/h)
    limit: float               # max rate it will follow / retention limit
    seq: int                   # arrival priority
    active: bool = True


@dataclass
class ResourceState:
    owner: str = OPERATOR
    limit: float = math.inf    # owner's retention limit
    rate: float = 0.0          # cached charged market rate
    acquired_t: float = 0.0
    last_accrual_t: float = 0.0


@dataclass
class VolatilityControls:
    max_bid_multiple: float = 0.0     # 0 = disabled
    floor_fall_rate: float = 0.0      # max fractional floor drop per hour
    min_holding_s: float = 0.0


class VisibilityError(Exception):
    pass


class Market:
    """The central arbiter: decentralized policies, centralized arbitration."""

    def __init__(self, topo: Topology,
                 controls: Optional[VolatilityControls] = None) -> None:
        self.topo = topo
        self.controls = controls or VolatilityControls()
        self.now = 0.0
        self.orders: Dict[int, Order] = {}
        self._books: Dict[int, List[Tuple[float, int, int]]] = {}
        self._floors: Dict[int, Tuple[float, float]] = {}  # node->(val,t)
        self.res: Dict[int, ResourceState] = {
            n.node_id: ResourceState()
            for n in topo.nodes if n.is_leaf}
        self.bills: Dict[str, float] = {}
        self.owned: Dict[str, Set[int]] = {}
        self.events: List[Tuple] = []
        # cb(now, leaf, old_owner, new_owner, rate, reason)
        self.on_transfer: List[Callable] = []
        self._order_seq = itertools.count()
        self._pending_crossings: Set[int] = set()
        # idle (operator-owned) descendant-leaf counts per node: lets the
        # hot path skip subtree scans when nothing is acquirable
        self._idle_count: Dict[int, int] = {}
        for leaf in self.res:
            for node in topo.ancestors(leaf):
                self._idle_count[node] = self._idle_count.get(node, 0) + 1
        self._live_count: Dict[int, int] = {}
        # idle-descent cache: per internal node, the child index where
        # the last _find_idle_leaf scan left off.  Children before the
        # hint are known idle-exhausted; the hint rewinds (in _set_owner)
        # when a leaf under an earlier child is freed, so repeated
        # "anywhere" matches cost amortized O(depth) instead of
        # rescanning every exhausted zone/rack left of the supply.
        self._idle_hint: Dict[int, int] = {}
        self._child_pos: Dict[int, int] = {
            c: i for n in topo.nodes for i, c in enumerate(n.children)}
        self.stats = {"orders": 0, "transfers": 0, "implicit_relinquish": 0,
                      "explicit_relinquish": 0, "cancels": 0}

    # ---------------------------------------------------------------- time
    def advance_to(self, t: float) -> None:
        assert t >= self.now - EPS, (t, self.now)
        self.now = max(self.now, t)
        if self._pending_crossings:
            for leaf in list(self._pending_crossings):
                self._check_limit(leaf)

    # ------------------------------------------------------------- billing
    def _accrue(self, leaf: int) -> None:
        st = self.res[leaf]
        dt_h = (self.now - st.last_accrual_t) / 3600.0
        if dt_h > 0 and st.owner != OPERATOR:
            self.bills[st.owner] = self.bills.get(st.owner, 0.0) \
                + st.rate * dt_h
        st.last_accrual_t = self.now

    # --------------------------------------------------------------- books
    def _book(self, node: int) -> List[Tuple[float, int, int]]:
        return self._books.setdefault(node, [])

    def _entry_live(self, entry: Tuple[float, int, int]) -> bool:
        """Live = order active AND entry price not stale (update_order
        re-pushes; old entries are lazily discarded)."""
        o = self.orders.get(entry[2])
        return o is not None and o.active and abs(-entry[0] - o.price) < EPS

    def _compact(self, node: int) -> None:
        book = self._books.get(node)
        if book is None:
            return
        live = [e for e in book if self._entry_live(e)]
        heapq.heapify(live)
        self._books[node] = live
        self._live_count[node] = len(live)

    def _top_entries(self, node: int, k: int = 8) -> List[Order]:
        """Best k live orders in one book (price desc, seq asc)."""
        book = self._books.get(node)
        if not book:
            return []
        while book and not self._entry_live(book[0]):
            heapq.heappop(book)
        if len(book) > 2 * self._live_count.get(node, 0) + 16:
            self._compact(node)
            book = self._books[node]
        out: List[Order] = []
        for entry in heapq.nsmallest(max(k * 2, 16), book):
            if self._entry_live(entry):
                out.append(self.orders[entry[2]])
                if len(out) >= k:
                    break
        return out

    def _second_tenant_price(self, node: int) -> float:
        """Best live price from a SECOND distinct tenant in this book.

        Any bid strictly below this price cannot move any leaf's charged
        rate, whoever the leaf's owner is: charged rates exclude the
        owner's own orders, and with two distinct tenants resting at or
        above p, at least one of them is a non-owner for every owner.
        Comparing against the raw top of book is NOT safe — the top bid
        may belong to the owner itself (the undercharging bug).
        Returns -inf (forces a refresh) when no such second tenant is
        found among the book's top entries.
        """
        top = self._top_entries(node, k=8)
        if not top:
            return -math.inf
        first = top[0].tenant
        for o in top[1:]:
            if o.tenant != first:
                return o.price
        return -math.inf

    def _best_in_book(self, node: int,
                      exclude: Optional[str]) -> Optional[Order]:
        """Best live non-excluded order in one book (price desc, seq asc).
        Falls back to a full sorted scan when the excluded tenant
        monopolizes the top entries — truncating there would hide real
        competing pressure (the undercharging bug class)."""
        for o in self._top_entries(node):
            if exclude is None or o.tenant != exclude:
                return o
        if exclude is None:
            return None
        book = self._books.get(node)
        if not book:
            return None
        for entry in sorted(book):
            if self._entry_live(entry):
                o = self.orders[entry[2]]
                if o.tenant != exclude:
                    return o
        return None

    def _best_bid(self, leaf: int, exclude: Optional[str]) -> Optional[Order]:
        best: Optional[Order] = None
        for node in self.topo.ancestors(leaf):
            o = self._best_in_book(node, exclude)
            if o is not None and (
                    best is None
                    or (o.price, -o.seq) > (best.price, -best.seq)):
                best = o
        return best

    # --------------------------------------------------------------- rates
    def floor(self, leaf: int) -> float:
        f = 0.0
        for node in self.topo.ancestors(leaf):
            v = self._floors.get(node)
            if v is not None:
                f = max(f, v[0])
        return f

    def _rate(self, leaf: int) -> float:
        st = self.res[leaf]
        best = self._best_bid(leaf, exclude=st.owner
                              if st.owner != OPERATOR else None)
        return max(self.floor(leaf), best.price if best else 0.0)

    def market_rate(self, leaf: int) -> float:
        return self.res[leaf].rate

    def _refresh_leaf(self, leaf: int) -> None:
        st = self.res[leaf]
        if st.owner == OPERATOR:
            # idle supply: the operator sells immediately to any covering
            # bid that meets the floor (its standing reclaim price)
            best = self._best_bid(leaf, exclude=None)
            if best is not None and best.price >= self.floor(leaf) - EPS:
                self._transfer(leaf, best)
                return
            st.rate = max(self.floor(leaf), best.price if best else 0.0)
            return
        new_rate = self._rate(leaf)
        if abs(new_rate - st.rate) > EPS:
            self._accrue(leaf)
            st.rate = new_rate
        self._check_limit(leaf)

    def _check_limit(self, leaf: int) -> None:
        st = self.res[leaf]
        if st.owner == OPERATOR or st.rate <= st.limit + EPS:
            self._pending_crossings.discard(leaf)
            return
        if self.now - st.acquired_t < self.controls.min_holding_s:
            self._pending_crossings.add(leaf)
            return
        self._pending_crossings.discard(leaf)
        self.stats["implicit_relinquish"] += 1
        self._do_relinquish(leaf, reason="limit")

    def _refresh_subtree(self, node: int) -> None:
        for leaf in self.topo.leaves_of(node):
            self._refresh_leaf(leaf)

    # ------------------------------------------------------------- tenants
    def place_order(self, tenant: str, scope: int, price: float,
                    limit: Optional[float] = None) -> int:
        """Place a scoped buy order (the OCO set over matching leaves)."""
        assert tenant != OPERATOR
        price = self._clip_bid(scope, price)
        limit = max(price, limit if limit is not None else price)
        oid = next(self._order_seq)
        o = Order(oid, tenant, scope, price, limit, oid)
        self.orders[oid] = o
        covered = self._second_tenant_price(scope)
        heapq.heappush(self._book(scope), (-price, o.seq, oid))
        self._live_count[scope] = self._live_count.get(scope, 0) + 1
        self.stats["orders"] += 1
        self.events.append(("order", self.now, tenant, scope, price, limit))
        # an incoming marketable order executes against idle supply FIRST;
        # only if it keeps resting does its pressure propagate (and possibly
        # evict owners whose retention limit it crosses)
        self._try_immediate_match(o, fresh=True)
        if o.active and price > covered + EPS:
            # fast path: a bid below the best second-distinct-tenant price
            # moves no rate (owner-exclusion-safe skip condition)
            self._refresh_subtree(scope)
        return oid

    def _find_idle_leaf(self, scope: int, max_floor: float) -> Optional[int]:
        """Descend idle-count-positive children to an operator-owned leaf
        whose floor the bid meets — amortized O(depth) via the per-node
        ``_idle_hint`` scan cache (children left of the hint hold no idle
        supply; the hint rewinds when supply under them reappears)."""
        if self._idle_count.get(scope, 0) == 0:
            return None
        node = self.topo.node(scope)
        if node.is_leaf:
            return scope if (self.res[scope].owner == OPERATOR and
                             self.floor(scope) <= max_floor + EPS) else None
        kids = node.children
        start = self._idle_hint.get(scope, 0)
        hint = start
        for i in range(start, len(kids)):
            c = kids[i]
            found = self._find_idle_leaf(c, max_floor)
            if found is not None:
                self._idle_hint[scope] = hint
                return found
            # the hint may only advance past a contiguous prefix of
            # exhausted children — a child whose idle supply is merely
            # floor-gated pins it (a later floor/bid may admit it)
            if hint == i and self._idle_count.get(c, 0) == 0:
                hint = i + 1
        self._idle_hint[scope] = hint
        return None

    def _try_immediate_match(self, o: Order, fresh: bool = False) -> None:
        """``fresh`` marks an order straight out of ``place_order`` whose
        pressure was never propagated (it is consumed before any refresh
        ran), so consuming it cannot change any cached rate."""
        leaf = self._find_idle_leaf(o.scope, o.price)
        if leaf is not None and o.active:
            self._transfer(leaf, o, fresh=fresh)

    def cancel_order(self, tenant: str, order_id: int) -> None:
        o = self.orders.get(order_id)
        if o is None or not o.active:
            return
        assert o.tenant == tenant
        o.active = False
        self._live_count[o.scope] = max(
            0, self._live_count.get(o.scope, 1) - 1)
        self.stats["cancels"] += 1
        self.events.append(("cancel", self.now, tenant, order_id))
        # a cancel can only LOWER rates, and only if the cancelled bid was
        # the best non-owner pressure for some owner; with a second
        # distinct tenant still resting at or above its price, every
        # owner-excluded rate is unchanged
        if o.price > self._second_tenant_price(o.scope) + EPS:
            self._refresh_subtree(o.scope)

    def update_order(self, tenant: str, order_id: int, price: float,
                     limit: Optional[float] = None) -> int:
        """Online re-bid: replace price/limit, keeping arrival priority."""
        o = self.orders[order_id]
        assert o.tenant == tenant and o.active
        price = self._clip_bid(o.scope, price)
        o.price = price
        o.limit = max(price, limit if limit is not None else price)
        heapq.heappush(self._book(o.scope), (-price, o.seq, order_id))
        self.events.append(("update", self.now, tenant, order_id, price))
        self._try_immediate_match(o)
        if o.active:
            self._refresh_subtree(o.scope)
        return order_id

    def set_retention_limit(self, tenant: str, leaf: int,
                            limit: float) -> None:
        st = self.res[leaf]
        assert st.owner == tenant, (st.owner, tenant)
        st.limit = limit
        self._check_limit(leaf)

    def relinquish(self, tenant: str, leaf: int) -> None:
        st = self.res[leaf]
        assert st.owner == tenant, (st.owner, tenant)
        self.stats["explicit_relinquish"] += 1
        self._do_relinquish(leaf, reason="explicit")

    # ------------------------------------------------------- transfer core
    def _do_relinquish(self, leaf: int, reason: str) -> None:
        st = self.res[leaf]
        old = st.owner
        self._accrue(leaf)
        winner = self._best_bid(leaf, exclude=old)
        if winner is not None and winner.price >= self.floor(leaf) - EPS:
            self._transfer(leaf, winner, reason=reason)
        else:
            # operator's standing reclaim bid wins
            self._set_owner(leaf, OPERATOR, math.inf)
            self.events.append(("reclaim", self.now, leaf, old, reason))
            self._refresh_leaf(leaf)
            for cb in self.on_transfer:
                cb(self.now, leaf, old, OPERATOR, self.res[leaf].rate,
                   reason)

    def _transfer(self, leaf: int, order: Order,
                  reason: str = "match", fresh: bool = False) -> None:
        st = self.res[leaf]
        old = st.owner
        self._accrue(leaf)
        order.active = False           # OCO: consuming the order cancels
        scope = order.scope            # every sibling bid atomically
        self._live_count[scope] = max(
            0, self._live_count.get(scope, 1) - 1)
        self._set_owner(leaf, order.tenant, order.limit)
        self.stats["transfers"] += 1
        self.events.append(("transfer", self.now, leaf, old, order.tenant,
                            reason))
        self._refresh_leaf(leaf)
        # the winner's pressure disappears everywhere it was resting — a
        # consume is a removal from the scope's book, exactly like a
        # cancel, so the same owner-exclusion-safe skip applies: with a
        # second distinct tenant still resting at or above the consumed
        # price, no owner-excluded rate under the scope depended on it.
        # A ``fresh`` order (immediate match during place_order) never
        # had its pressure propagated at all, so its removal can change
        # nothing.  Together these turn marketable "anywhere" bids that
        # match instantly (the fig12a hot path) from O(n_leaves) into
        # O(depth).
        if not fresh and \
                order.price > self._second_tenant_price(scope) + EPS:
            self._refresh_subtree(scope)
        for cb in self.on_transfer:
            cb(self.now, leaf, old, order.tenant, st.rate, reason)

    def _set_owner(self, leaf: int, tenant: str, limit: float) -> None:
        st = self.res[leaf]
        was_idle = st.owner == OPERATOR
        if not was_idle:
            self.owned.setdefault(st.owner, set()).discard(leaf)
        st.owner = tenant
        st.limit = limit
        st.acquired_t = self.now
        st.last_accrual_t = self.now
        now_idle = tenant == OPERATOR
        if not now_idle:
            self.owned.setdefault(tenant, set()).add(leaf)
        if was_idle != now_idle:
            delta = 1 if now_idle else -1
            for node in self.topo.ancestors(leaf):
                self._idle_count[node] = self._idle_count.get(node, 0) \
                    + delta
                if delta > 0:
                    # idle supply reappeared under this node: rewind the
                    # parent's idle-descent hint so the freed child is
                    # scanned again
                    par = self.topo.node(node).parent
                    if par is not None:
                        pos = self._child_pos[node]
                        if self._idle_hint.get(par, 0) > pos:
                            self._idle_hint[par] = pos

    # ------------------------------------------------------------ operator
    def set_floor(self, node: int, price: float) -> None:
        """Operator floor (standing reclaim bid) on a node/subtree."""
        cur = self._floors.get(node)
        if cur is not None and price < cur[0] and \
                self.controls.floor_fall_rate > 0:
            dt_h = (self.now - cur[1]) / 3600.0
            min_allowed = cur[0] * max(
                0.0, 1.0 - self.controls.floor_fall_rate * dt_h)
            price = max(price, min_allowed)
        self._floors[node] = (price, self.now)
        self.events.append(("floor", self.now, node, price))
        self._refresh_subtree(node)

    def _clip_bid(self, scope: int, price: float) -> float:
        mult = self.controls.max_bid_multiple
        if mult <= 0:
            return price
        ref = 0.0
        for node in self.topo.ancestors(scope):
            v = self._floors.get(node)
            if v is not None:
                ref = max(ref, v[0])
        top = self._top_entries(scope, 1)
        if top:
            ref = max(ref, top[0].price)
        for leaf in self.topo.leaves_of(scope)[:64]:
            ref = max(ref, self.res[leaf].rate)
        if ref <= 0:
            return price
        return min(price, ref * mult)

    # ---------------------------------------------------- price discovery
    def visible_domain(self, tenant: str) -> Set[int]:
        dom: Set[int] = set(self.topo.roots.values())
        for leaf in self.owned.get(tenant, ()):  # ancestors of owned leaves
            dom.update(self.topo.ancestors(leaf))
        return dom

    def acquire_price(self, leaf: int, tenant: str) -> float:
        """Rate a tenant must exceed to acquire this leaf right now.

        The querying tenant's own resting bids are excluded from the
        competing price — they would be OCO-replaced, not outbid (a tenant
        never has to outbid itself)."""
        st = self.res[leaf]
        if st.owner == tenant:
            return math.inf
        best = self._best_bid(leaf, exclude=tenant)
        comp = max(self.floor(leaf), best.price + TICK if best else 0.0)
        if st.owner == OPERATOR:
            return comp
        if math.isinf(st.limit):
            return math.inf
        return max(comp, st.limit + TICK)

    def query_price(self, tenant: str, scope: int,
                    enforce_visibility: bool = True) -> float:
        """Cheapest acquirable matching descendant's price (paper §4.4)."""
        if enforce_visibility and scope not in self.visible_domain(tenant):
            raise VisibilityError(
                f"{tenant} may not query node {scope}; visible domain is "
                f"roots + ancestors of owned resources")
        return min((self.acquire_price(leaf, tenant)
                    for leaf in self.topo.leaves_of(scope)),
                   default=math.inf)

    # ------------------------------------------------------------- helpers
    def owner_of(self, leaf: int) -> str:
        return self.res[leaf].owner

    def owned_leaves(self, tenant: str) -> Set[int]:
        return set(self.owned.get(tenant, ()))

    def tenant_orders(self, tenant: str) -> List[Order]:
        return [o for o in self.orders.values()
                if o.tenant == tenant and o.active]

    def settle(self, t: Optional[float] = None) -> Dict[str, float]:
        """Accrue all leaves up to t and return the bills."""
        if t is not None:
            self.advance_to(t)
        for leaf in self.res:
            self._accrue(leaf)
        return dict(self.bills)
