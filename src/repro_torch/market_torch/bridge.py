"""BatchMarket: a ``Market``-compatible facade over the PyTorch batch
engine — the twin of ``repro.market_jax.bridge``.

The simulator, the EconAdapters and the InfraMaps speak the event
market's vocabulary: string tenants, topology node ids, synchronous
place / cancel / relinquish calls.  The engine speaks dense tensors:
int tenant ids and (level, node-index) scopes over one regular
``TreeSpec`` per resource type.  This facade owns the mapping:

  * string tenant <-> dense int id (< n_tenants), interned on first use;
  * topology node <-> (rtype, level-from-leaf d, node index), derived
    from the DFS leaf order (``build_cluster`` fills sequentially, so
    node k at level d covers leaves [k*stride_d, (k+1)*stride_d));
  * every mutating call runs one ``BatchEngine.step`` at the current
    clock, so callers see the event engine's synchronous semantics.

After each such step the facade takes one device-to-host copy: the
bid table, the per-leaf state, the bills, the floors, the clock and
the step's transfer arrays, packed into one int32 buffer.  Queries,
``settle`` and the transfer callbacks read that numpy copy.

The fleet drives the same engines through the array-native hooks
(``leaf_view``, ``cancel_all``, ``step_arrays``, ``set_health``), where
fleet tenant ids are engine tenant ids.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.market import OPERATOR, TICK, VisibilityError, \
    VolatilityControls
from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.market_torch import schema
from repro_torch.market_torch.engine import NEG, BatchEngine, TreeSpec

# the engine-state keys the host copy holds (besides floors, t, head)
_HOST_KEYS = ("price", "blimit", "level", "node", "tenant", "seq", "owner",
              "limit", "rate", "bills", "health")


@dataclass
class _Order:
    """Lightweight handle mirroring ``market.Order`` for adapter code.
    ``gen`` guards against ring-buffer slot reuse: a stale handle whose
    slot was recycled reports inactive instead of aliasing the newer
    order.  ``seq`` is the engine's monotone arrival stamp — the
    equal-price tie-break priority, mirroring ``market.Order.seq``."""
    order_id: int
    tenant: str
    scope: int
    price: float
    limit: float
    rtype: str
    slot: int
    gen: int
    seq: int
    market: "BatchMarket"

    @property
    def active(self) -> bool:
        if self.market._slot_gen[self.rtype][self.slot] != self.gen:
            return False
        host = self.market._host(self.rtype)
        return bool(host["tenant"][self.slot]
                    == self.market._tenant_id(self.tenant)) \
            and host["price"][self.slot] > NEG / 2


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """Flat int32 view of a tensor: float32 bits reinterpreted, every
    other dtype converted."""
    x = x.reshape(-1)
    if x.dtype == torch.float32:
        return x.contiguous().view(torch.int32)
    return x.to(torch.int32)


class BatchMarket:
    """Market-compatible surface over per-rtype batch engines."""

    def __init__(self, topo: Topology,
                 controls: Optional[VolatilityControls] = None,
                 capacity: int = 1 << 12, n_tenants: int = 256,
                 k: int = 8, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.topo = topo
        self.controls = controls or VolatilityControls()
        self.now = 0.0
        self.n_tenants = n_tenants
        self.k = k
        self.engines: Dict[str, BatchEngine] = {}
        self.states: Dict[str, dict] = {}
        self._np: Dict[str, Optional[dict]] = {}
        # topology <-> dense layout maps
        self._leaf_local: Dict[int, Tuple[str, int]] = {}
        self._leaf_global: Dict[str, List[int]] = {}
        self._node_map: Dict[int, Tuple[str, int, int]] = {}
        self._tenants: Dict[str, int] = {}
        self._tenant_names: List[str] = []
        self.orders: Dict[int, _Order] = {}
        self._slot_gen: Dict[str, np.ndarray] = {}
        self._next_oid = 0
        self.bills: Dict[str, float] = {}
        self.on_transfer: List[Callable] = []
        self.stats = {"orders": 0, "transfers": 0, "implicit_relinquish": 0,
                      "explicit_relinquish": 0, "cancels": 0,
                      "revoked_by_fault": 0}
        for rtype, root in topo.roots.items():
            self._build_tree(rtype, root, capacity)

    # ---------------------------------------------------------- layout
    def _build_tree(self, rtype: str, root: int, capacity: int) -> None:
        """Regular tree of one resource type: the stride at level d is
        the largest leaf count under a node of that level; topology
        nodes, leaves included (a leaf is its own level-0 ancestor), map
        to (rtype, level, first_leaf // stride)."""
        topo = self.topo
        leaves = topo.leaves_of(root)
        depth = max(len(topo.ancestors(leaf)) for leaf in leaves)
        if not all(len(topo.ancestors(leaf)) == depth for leaf in leaves):
            raise ValueError("BatchMarket needs uniform-depth trees")
        self._leaf_global[rtype] = list(leaves)
        leaf_pos = {leaf: i for i, leaf in enumerate(leaves)}
        for leaf, i in leaf_pos.items():
            self._leaf_local[leaf] = (rtype, i)
        by_level: Dict[int, List[int]] = {}
        for leaf in leaves:
            for d, nid in enumerate(topo.ancestors(leaf)):
                by_level.setdefault(d, [])
                if nid not in by_level[d]:
                    by_level[d].append(nid)
        strides = [max(len(topo.leaves_of(nid)) for nid in by_level[d])
                   for d in range(depth)]
        tree = TreeSpec(n_leaves=len(leaves), strides=tuple(strides))
        for d in range(depth):
            for nid in by_level[d]:
                idx = leaf_pos[topo.leaves_of(nid)[0]] // strides[d]
                self._node_map[nid] = (rtype, d, idx)
        eng = BatchEngine(tree, capacity=capacity, n_tenants=self.n_tenants,
                          controls=self.controls, k=self.k,
                          device=self.device)
        self.engines[rtype] = eng
        self.states[rtype] = eng.init_state()
        self._np[rtype] = None
        self._slot_gen[rtype] = np.zeros(capacity, np.int64)

    def _tenant_id(self, tenant: str) -> int:
        tid = self._tenants.get(tenant)
        if tid is None:
            tid = len(self._tenant_names)
            if tid >= self.n_tenants:
                raise RuntimeError(f"tenant table full ({self.n_tenants})")
            self._tenants[tenant] = tid
            self._tenant_names.append(tenant)
        return tid

    def _tenant_name(self, tid: int) -> str:
        return self._tenant_names[tid] if tid >= 0 else OPERATOR

    def _scalar(self, v, dtype) -> torch.Tensor:
        return torch.tensor([v], dtype=dtype, device=self.device)

    # ------------------------------------------------------- host copy
    def _pull(self, rtype: str, transfers=None):
        """One device-to-host copy of the cached keys, the floors, the
        clock, the ring cursor and (given ``transfers``) the step's
        ``old`` owners and fault revocations.  Caches and returns the
        host dict, and ``(old, revoked)`` when asked."""
        st = self.states[rtype]
        parts = [st[k] for k in _HOST_KEYS] + list(st["floor"]) \
            + [st["t"], st["head"]]
        if transfers is not None:
            parts += [transfers["old"], transfers["revoked_by_fault"]]
        flat = torch.cat([_as_i32(p) for p in parts]).cpu().numpy()
        out, off = [], 0
        for p in parts:
            n = p.numel()
            a = flat[off:off + n].reshape(p.shape)
            out.append(a.view(np.float32) if p.dtype == torch.float32
                       else a)
            off += n
        n_keys, n_floor = len(_HOST_KEYS), len(st["floor"])
        h = dict(zip(_HOST_KEYS, out[:n_keys]))
        h["floor"] = out[n_keys:n_keys + n_floor]
        h["t"] = float(out[n_keys + n_floor])
        h["head"] = int(out[n_keys + n_floor + 1])
        h["_src"] = st
        self._np[rtype] = h
        if transfers is None:
            return h
        return h, (out[-2], out[-1].astype(bool))

    def _host(self, rtype: str) -> dict:
        """Host (numpy) view of the engine state, cached per step."""
        h = self._np[rtype]
        if h is None or h["_src"] is not self.states[rtype]:
            h = self._pull(rtype)
        return h

    # ------------------------------------------------------------ steps
    def _step(self, rtype: str, new_bids=None, floors=None,
              relinquish=None, explicit: Set[int] = frozenset()) -> None:
        eng = self.engines[rtype]
        st, transfers, _ = eng.step(self.states[rtype], self.now,
                                    new_bids, floors, relinquish)
        self.states[rtype] = st
        schema.maybe_validate(st, eng, where=f"{rtype} state")
        _, (old, rev) = self._pull(rtype, transfers)
        self._fire(rtype, old, rev, explicit)

    def _fire(self, rtype: str, old: np.ndarray, rev: np.ndarray,
              explicit) -> None:
        """Count one step's transfers and call ``on_transfer`` for each
        moved leaf, in leaf order, with its reason: ``match`` (from the
        operator), ``limit`` (an implicit relinquishment), ``explicit``,
        ``fault`` (revoked from a DOWN leaf) or ``reclaim``."""
        host = self._host(rtype)
        new = host["owner"]
        moved = old != new
        if not moved.any():
            return
        if isinstance(explicit, torch.Tensor):
            # the fleet's per-leaf graceful-release mask
            explicit = set(torch.nonzero(explicit)[:, 0].tolist())
        rates = host["rate"]
        leaves = self._leaf_global[rtype]
        for i in np.nonzero(moved)[0]:
            leaf = leaves[i]
            if int(new[i]) >= 0:
                reason = "explicit" if i in explicit else (
                    "match" if int(old[i]) < 0 else "limit")
                self.stats["transfers"] += 1
                if reason == "limit":
                    self.stats["implicit_relinquish"] += 1
            elif rev[i]:
                reason = "fault"
                self.stats["revoked_by_fault"] += 1
            else:
                reason = "explicit" if i in explicit else "reclaim"
            for cb in self.on_transfer:
                cb(self.now, leaf, self._tenant_name(int(old[i])),
                   self._tenant_name(int(new[i])), float(rates[i]),
                   reason)

    def _bid_arrays(self, price, limit, level, node, tenant):
        """One bid as the engine's batch dict of 1-element tensors."""
        f32, i32 = torch.float32, torch.int32
        return {"price": self._scalar(price, f32),
                "limit": self._scalar(limit, f32),
                "level": self._scalar(level, i32),
                "node": self._scalar(node, i32),
                "tenant": self._scalar(tenant, i32)}

    def _count(self, transfers, explicit=None) -> None:
        """Market stats of one fleet step, as the reference counts them
        when no transfer callback is registered."""
        moved, new, old = (transfers["moved"], transfers["new"],
                           transfers["old"])
        taken = moved & (new >= 0)
        expl = torch.zeros_like(moved) if explicit is None \
            else explicit.to(torch.bool)
        self.stats["transfers"] += int(taken.sum())
        self.stats["explicit_relinquish"] += int((moved & expl).sum())
        self.stats["implicit_relinquish"] += int(
            (taken & ~expl & (old >= 0)).sum())
        self.stats["revoked_by_fault"] += int(
            transfers["revoked_by_fault"].sum())

    # ------------------------------------------------------ fleet hooks
    def leaf_view(self, rtype: str):
        """``(owner, rate, floors)`` of one engine, as device tensors."""
        st = self.states[rtype]
        return st["owner"], st["rate"], tuple(st["floor"])

    def cancel_all(self, rtype: str) -> None:
        """Kill every resting order (the next step re-clears)."""
        eng = self.engines[rtype]
        self.states[rtype] = eng.cancel_all(self.states[rtype])
        self._np[rtype] = None

    def step_arrays(self, rtype: str, t: float, bids=None,
                    relinquish=None, limits=None, explicit=None):
        """One engine epoch at ``t`` with a whole event batch; ``explicit``
        is the (n_leaves,) graceful-release mask.  Fires ``on_transfer``
        when callbacks are registered, updates the stats either way, and
        returns the transfers dict."""
        if t < self.now - 1e-9:
            raise ValueError(f"time went backwards: {t} < {self.now}")
        self.now = max(self.now, t)
        eng = self.engines[rtype]
        st, transfers, _ = eng.step(self.states[rtype], self.now, bids,
                                    None, relinquish, limits)
        self.states[rtype] = st
        self._np[rtype] = None
        schema.maybe_validate(st, eng, where=f"{rtype} state")
        if bids is not None:
            self.stats["orders"] += int((bids["tenant"] >= 0).sum())
        if self.on_transfer:
            _, (old, rev) = self._pull(rtype, transfers)
            self._fire(rtype, old, rev,
                       frozenset() if explicit is None else explicit)
        else:
            self._count(transfers, explicit)
        return transfers

    def set_health(self, node: int, value: int) -> None:
        """Set failure-domain health at any topology node (leaf, host,
        rack, zone): every engine leaf under it gets ``value``
        (``engine.HEALTH_UP/DRAINING/DOWN``) in one scatter.  Owners on
        newly-down leaves are force-evicted by the next step."""
        rtype, d, idx = self._node_map[node]
        eng = self.engines[rtype]
        i32 = torch.int32
        self.states[rtype] = eng.set_health(
            self.states[rtype], self._scalar(d, i32), self._scalar(idx, i32),
            self._scalar(value, i32))
        self._np[rtype] = None

    def reset(self) -> None:
        """Fresh engine state (same layout) and an empty order book;
        floors must be re-seeded by the caller."""
        for rtype, eng in self.engines.items():
            self.states[rtype] = eng.init_state()
            self._np[rtype] = None
            self._slot_gen[rtype][:] = 0
        self.now = 0.0
        self.orders.clear()
        self.bills = {}
        self._next_oid = 0
        self.stats = {k: 0 for k in self.stats}

    # ----------------------------------------------------------- tenants
    def advance_to(self, t: float) -> None:
        if t < self.now - 1e-9:
            raise ValueError(f"time went backwards: {t} < {self.now}")
        if t <= self.now:
            return
        self.now = max(self.now, t)
        for rtype in self.engines:
            self._step(rtype)

    def _next_slot(self, rtype: str) -> Optional[int]:
        """The slot the engine's skip-over-live allocator will pick for
        the next single bid: the first free slot in ring order from the
        cursor (None when the table is full)."""
        host = self._host(rtype)
        cap = self.engines[rtype].capacity
        live = (host["price"] > NEG / 2) & (host["tenant"] >= 0)
        if live.all():
            return None
        ring = (np.arange(cap) - host["head"]) % cap
        return int(np.argmin(np.where(live, cap, ring)))

    def place_order(self, tenant: str, scope: int, price: float,
                    limit: Optional[float] = None) -> int:
        if tenant == OPERATOR:
            raise ValueError("the operator places no orders")
        rtype, d, idx = self._node_map[scope]
        tid = self._tenant_id(tenant)
        limit = limit if limit is not None else price
        slot = self._next_slot(rtype)
        if slot is None:
            # the engine would drop the bid (state["dropped"]): the
            # synchronous facade fails loudly instead
            raise RuntimeError(
                f"{rtype} bid table full (capacity "
                f"{self.engines[rtype].capacity}): the synchronous facade "
                f"cannot drop bids; raise BatchMarket(capacity=...)")
        self._slot_gen[rtype][slot] += 1
        self._step(rtype, new_bids=self._bid_arrays(price, limit, d, idx,
                                                    tid))
        oid = self._next_oid
        self._next_oid += 1
        seq = int(self._host(rtype)["seq"][slot])
        self.orders[oid] = _Order(oid, tenant, scope, price, limit, rtype,
                                  slot, int(self._slot_gen[rtype][slot]),
                                  seq, self)
        self.stats["orders"] += 1
        return oid

    def cancel_order(self, tenant: str, order_id: int) -> None:
        o = self.orders.get(order_id)
        if o is None or not o.active:
            return
        if o.tenant != tenant:
            raise ValueError(f"order {order_id} belongs to {o.tenant}")
        eng = self.engines[o.rtype]
        self.states[o.rtype] = eng.cancel(
            self.states[o.rtype], self._scalar(o.slot, torch.int32))
        self.stats["cancels"] += 1
        # re-clear at the same timestamp so cached rates refresh
        self._step(o.rtype)

    def _check_owner(self, rtype: str, i: int, tenant: str) -> None:
        owner = int(self._host(rtype)["owner"][i])
        if owner != self._tenant_id(tenant):
            raise ValueError(f"{tenant} does not own leaf {i} of {rtype} "
                             f"(owner {self._tenant_name(owner)})")

    def relinquish(self, tenant: str, leaf: int) -> None:
        rtype, i = self._leaf_local[leaf]
        self._check_owner(rtype, i, tenant)
        self.stats["explicit_relinquish"] += 1
        self._step(rtype, relinquish=self._scalar(i, torch.int32),
                   explicit={i})

    def set_retention_limit(self, tenant: str, leaf: int,
                            limit: float) -> None:
        rtype, i = self._leaf_local[leaf]
        self._check_owner(rtype, i, tenant)
        st = dict(self.states[rtype])
        lim = st["limit"].clone()       # a caller may hold the old state
        lim[i] = limit
        st["limit"] = lim
        self.states[rtype] = st
        self._step(rtype)   # the new limit may fire an eviction

    # ----------------------------------------------------------- operator
    def set_floor(self, node: int, price: float) -> None:
        """Propose an operator floor at one topology node and step."""
        rtype, d, idx = self._node_map[node]
        eng = self.engines[rtype]
        floors = [torch.full((eng.tree.nodes_at(lvl),), -1.0,
                             dtype=torch.float32, device=self.device)
                  for lvl in range(eng.tree.n_levels)]
        floors[d][idx] = price
        self._step(rtype, floors=tuple(floors))

    def floor(self, leaf: int) -> float:
        rtype, i = self._leaf_local[leaf]
        host = self._host(rtype)
        strides = self.engines[rtype].tree.strides
        return max(float(host["floor"][d][i // s])
                   for d, s in enumerate(strides))

    # ------------------------------------------------------------ queries
    def market_rate(self, leaf: int) -> float:
        rtype, i = self._leaf_local[leaf]
        return float(self._host(rtype)["rate"][i])

    def owner_of(self, leaf: int) -> str:
        rtype, i = self._leaf_local[leaf]
        return self._tenant_name(int(self._host(rtype)["owner"][i]))

    def owned_leaves(self, tenant: str) -> Set[int]:
        tid = self._tenants.get(tenant)
        if tid is None:
            return set()
        out: Set[int] = set()
        for rtype, leaves in self._leaf_global.items():
            owner = self._host(rtype)["owner"]
            out.update(leaves[i] for i in np.nonzero(owner == tid)[0])
        return out

    def tenant_orders(self, tenant: str) -> List[_Order]:
        return [o for o in self.orders.values()
                if o.tenant == tenant and o.active]

    def visible_domain(self, tenant: str) -> Set[int]:
        dom: Set[int] = set(self.topo.roots.values())
        for leaf in self.owned_leaves(tenant):
            dom.update(self.topo.ancestors(leaf))
        return dom

    def _best_excl(self, rtype: str, i: int, exclude_tid: int) -> float:
        """Best live covering bid price for local leaf i, excluding one
        tenant (vectorized over the host copy of the bid table)."""
        host = self._host(rtype)
        strides = np.array(self.engines[rtype].tree.strides)
        live = (host["price"] > NEG / 2) & (host["tenant"] >= 0) \
            & (host["tenant"] != exclude_tid)
        covers = host["node"] == (i // strides[host["level"]])
        prices = np.where(live & covers, host["price"], NEG)
        return float(prices.max()) if prices.size else NEG

    def acquire_price(self, leaf: int, tenant: str) -> float:
        rtype, i = self._leaf_local[leaf]
        host = self._host(rtype)
        tid = self._tenant_id(tenant)
        if int(host["owner"][i]) == tid:
            return math.inf
        best = self._best_excl(rtype, i, tid)
        comp = max(self.floor(leaf), best + TICK if best > NEG / 2 else 0.0)
        if int(host["owner"][i]) < 0:
            return comp
        lim = float(host["limit"][i])
        if math.isinf(lim):
            return math.inf
        return max(comp, lim + TICK)

    def query_price(self, tenant: str, scope: int,
                    enforce_visibility: bool = True) -> float:
        if enforce_visibility and scope not in self.visible_domain(tenant):
            raise VisibilityError(
                f"{tenant} may not query node {scope}; visible domain is "
                f"roots + ancestors of owned resources")
        return min((self.acquire_price(leaf, tenant)
                    for leaf in self.topo.leaves_of(scope)),
                   default=math.inf)

    # ------------------------------------------------------------ billing
    def settle(self, t: Optional[float] = None) -> Dict[str, float]:
        """Bills to ``now`` (advanced to ``t`` first when given): the
        engine's accrued bills plus the accrual since its last step at
        the current rates, without stepping."""
        if t is not None:
            self.advance_to(t)
        bills: Dict[str, float] = {}
        for rtype in self.engines:
            host = self._host(rtype)
            vec = host["bills"]
            dt_h = max(self.now - host["t"], 0.0) / 3600.0
            owner = host["owner"]
            rate = host["rate"]
            extra = np.zeros_like(vec)
            if dt_h > 0:
                np.add.at(extra, owner[owner >= 0],
                          rate[owner >= 0] * dt_h)
            for tid, total in enumerate(vec + extra):
                if total != 0.0:
                    name = self._tenant_name(tid)
                    bills[name] = bills.get(name, 0.0) + float(total)
        self.bills = bills
        return dict(bills)
