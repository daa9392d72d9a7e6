"""Batch market engine on PyTorch tensors — the twin of
``repro.market_jax.engine`` (same state contract, same results).

One type-tree with regular strides (leaf ancestor at level d = leaf //
stride[d]).  The engine holds a bounded bid table (a ring buffer of OCO
scoped orders), per-leaf ownership and per-tenant bills; ``step`` runs
one market epoch: billing accrual, fault eviction, deferred evictions,
limit refresh, operator floors, bid admission (clipped by the volatility
controls), then the clear / evict / transfer cascade to fixpoint.

The sorted book view (``order``, ``sorted_gseg``, ``seg_start``, sorted
by segment asc, price desc, seq asc) is kept incrementally by ``place``:
the incoming batch is sorted alone and merged into the live view, with a
full sort only when the view's dead fraction passes
``resort_dead_frac`` (``state["resorts"]`` counts those).  Every other
mutation only kills entries, which keeps the view valid
(docs/DESIGN.md §10).

Where the reference runs ``lax.while_loop`` / ``lax.cond`` on the
device, this engine loops on the host with one device read per check:
the cascade's wave loop, its claim-round loop, and the full-resort
choice in ``place``.  State is never updated in place: every method
returns a new dict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.market import VolatilityControls
from repro_torch.device import (DeviceLike, arange32, f32_order_key, fma,
                                i32, recip32, resolve_device, scatter_add_drop,
                                scatter_drop, seq_scatter_add)
from repro_torch.kernels.market_clear import ops as clear_ops
from repro_torch.kernels.market_clear import ref as R

NEG = R.NEG
EPSF = R.EPSF
HEALTH_UP = R.HEALTH_UP
HEALTH_DRAINING = R.HEALTH_DRAINING
HEALTH_DOWN = R.HEALTH_DOWN

F32 = torch.float32
I32 = torch.int32
PER_HOUR = recip32(3600.0)   # seconds -> hours, as the reference rounds it


@dataclass(frozen=True)
class TreeSpec:
    """Regular type-tree: strides per level, leaf->root order.
    E.g. (1, 8, 32, 128, n_leaves) = instance/host/rack/zone/root."""
    n_leaves: int
    strides: Tuple[int, ...]

    @property
    def n_levels(self) -> int:
        return len(self.strides)

    def nodes_at(self, d: int) -> int:
        return -(-self.n_leaves // self.strides[d])


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather with the reference's index semantics: negative indices
    wrap once, then indices clamp into range."""
    n = arr.shape[0]
    idx = idx.long()
    return arr[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


class BatchEngine:
    def __init__(self, tree: TreeSpec, capacity: int = 1 << 16,
                 n_tenants: int = 1024,
                 controls: Optional[VolatilityControls] = None,
                 k: int = 8, incremental_sort: bool = True,
                 resort_dead_frac: float = 0.5,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.tree = tree
        self.capacity = capacity
        self.n_tenants = n_tenants
        self.controls = controls or VolatilityControls()
        self.k = max(1, int(k))   # contested claims resolved per wave
        self.incremental_sort = bool(incremental_sort)
        self.resort_dead_frac = float(resort_dead_frac)
        # global segment layout: segment id of (level d, node i) is
        # level_off[d] + i; n_seg_total is the dead-slot sentinel
        off, acc = [], 0
        for d in range(tree.n_levels):
            off.append(acc)
            acc += tree.nodes_at(d)
        self.level_off = tuple(off)
        self.n_seg_total = acc
        dev = self.device
        self._off = torch.tensor(self.level_off, dtype=I32, device=dev)
        self._nd = torch.tensor([tree.nodes_at(d)
                                 for d in range(tree.n_levels)],
                                dtype=I32, device=dev)
        self._strides = torch.tensor(tree.strides, dtype=I32, device=dev)

    def _scalar(self, v, dtype=I32) -> torch.Tensor:
        return torch.tensor(v, dtype=dtype, device=self.device)

    def init_state(self) -> Dict[str, object]:
        t, cap, dev = self.tree, self.capacity, self.device

        def full(n, v, dtype):
            return torch.full((n,), v, dtype=dtype, device=dev)
        return {
            # bid table (ring buffer of OCO scoped orders)
            "price": full(cap, NEG, F32),
            "blimit": full(cap, float("inf"), F32),
            "level": full(cap, 0, I32),
            "node": full(cap, 0, I32),
            "tenant": full(cap, -1, I32),
            "seq": full(cap, 0, I32),               # arrival stamps
            "next_seq": self._scalar(0),            # monotone counter
            "head": self._scalar(0),                # ring-buffer cursor
            "dropped": self._scalar(0),             # overflow drops
            # sorted book view
            "order": arange32(cap, dev),
            "sorted_gseg": full(cap, self.n_seg_total, I32),
            "seg_start": full(self.n_seg_total + 1, 0, I32),
            # per-leaf ownership and health
            "owner": full(t.n_leaves, -1, I32),
            "limit": full(t.n_leaves, float("inf"), F32),
            "acq_t": full(t.n_leaves, 0.0, F32),
            "rate": full(t.n_leaves, 0.0, F32),
            "health": full(t.n_leaves, 0, I32),
            # billing and instrumentation
            "bills": full(self.n_tenants, 0.0, F32),
            "t": self._scalar(0.0, F32),
            "waves": self._scalar(0),
            "resorts": self._scalar(0),
            # operator floors and their last-update times, per level
            "floor": [full(t.nodes_at(d), 0.0, F32)
                      for d in range(t.n_levels)],
            "floor_t": [full(t.nodes_at(d), 0.0, F32)
                        for d in range(t.n_levels)],
        }

    # ------------------------------------------------------------------
    def _gseg_of(self, level, node, live):
        lvl = level.clamp(0, self.tree.n_levels - 1).long()
        node = torch.minimum(node.clamp_min(0), self._nd[lvl] - 1)
        return torch.where(live, self._off[lvl] + node, self.n_seg_total)

    def _gseg(self, state):
        """Current global segment id per slot (sentinel where dead)."""
        live = (state["price"] > NEG / 2) & (state["tenant"] >= 0)
        return self._gseg_of(state["level"], state["node"], live)

    def _seg_start(self, sg):
        return torch.searchsorted(
            sg, arange32(self.n_seg_total + 1, self.device),
            side="left", out_int32=True)

    def _resort(self, state):
        """The full-table sort: rebuild the view and count it."""
        order, sg = R.sort_book(self._gseg(state), state["price"],
                                state["seq"])
        state["order"] = order
        state["sorted_gseg"] = sg
        state["seg_start"] = self._seg_start(sg)
        state["resorts"] = state["resorts"] + 1
        return state

    def _merged_view(self, state, old_order, old_sg, old_live_s,
                     bs_gseg, bs_slot, n_new):
        """Merge the sorted live book with the sorted incoming batch.

        Seq stamps are monotone, so every resting order precedes every
        batch entry on equal (segment, price); each entry's merged
        position is its own rank plus the other side's entries before
        it — one vectorized binary search over the batch, and a
        histogram cumsum for the reverse count.  Holes are compacted
        out.  Returns ``(order, sorted_gseg, seg_start)``."""
        cap, dev = self.capacity, self.device
        b = bs_gseg.shape[0]
        slot = arange32(cap, dev)
        price = state["price"]
        tenant = state["tenant"]
        r_old = torch.cumsum(i32(old_live_s), 0, dtype=I32) - 1
        n_old = old_live_s.sum(dtype=I32)
        comp_idx = torch.where(old_live_s, r_old, cap)
        comp_order = scatter_drop(torch.zeros(cap, dtype=I32, device=dev),
                                  comp_idx, old_order)
        comp_gseg = scatter_drop(
            torch.full((cap,), self.n_seg_total, dtype=I32, device=dev),
            comp_idx, old_sg)
        comp_price = scatter_drop(
            torch.full((cap,), NEG, dtype=F32, device=dev), comp_idx,
            price[old_order.long()])
        bs_price = price[bs_slot.long()]
        lo = torch.zeros(b, dtype=I32, device=dev)
        hi = torch.full((b,), cap, dtype=I32, device=dev)
        for _ in range(int(cap).bit_length() + 1):
            act = lo < hi
            mid = ((lo + hi) >> 1).clamp(0, cap - 1)
            midl = mid.long()
            kg, kp = comp_gseg[midl], comp_price[midl]
            before = (kg < bs_gseg) | ((kg == bs_gseg) & (kp >= bs_price))
            lo = torch.where(act & before, mid + 1, lo)
            hi = torch.where(act & ~before, mid, hi)
        cnt_old = lo
        j = arange32(b, dev)
        pos_new = j + cnt_old
        valid_old = slot < n_old
        hist = scatter_add_drop(
            cap + 1, torch.where(j < n_new, cnt_old, cap + 1),
            torch.ones(b, dtype=I32, device=dev))
        cnt_new = torch.cumsum(hist, 0, dtype=I32)[:cap]
        pos_old = slot + cnt_new
        n_total = n_old + n_new
        live_after = (price > NEG / 2) & (tenant >= 0)
        dead = ~live_after
        pos_dead = n_total + torch.cumsum(i32(dead), 0, dtype=I32) - 1
        order = torch.zeros(cap, dtype=I32, device=dev)
        order = scatter_drop(order, torch.where(valid_old, pos_old, cap),
                             comp_order)
        order = scatter_drop(order, torch.where(j < n_new, pos_new, cap),
                             bs_slot)
        order = scatter_drop(order, torch.where(dead, pos_dead, cap), slot)
        sg = torch.full((cap,), self.n_seg_total, dtype=I32, device=dev)
        sg = scatter_drop(sg, torch.where(valid_old, pos_old, cap),
                          comp_gseg)
        sg = scatter_drop(sg, torch.where(j < n_new, pos_new, cap),
                          bs_gseg)
        return order, sg, self._seg_start(sg)

    # ------------------------------------------------------------------
    def place(self, state, prices, levels, nodes, tenants, limits=None):
        """Insert a batch of scoped bids into free table slots, in ring
        order from ``head``, skipping live resting orders; overflow is
        dropped and counted in ``state["dropped"]``.  Each accepted bid
        gets the next ``seq`` stamp in batch order.  No volatility
        clipping and no re-clear: ``step`` does those."""
        if limits is None:
            limits = prices
        cap, dev = self.capacity, self.device
        slot = arange32(cap, dev)
        live_tab = (state["price"] > NEG / 2) & (state["tenant"] >= 0)
        head = state["head"]
        # free slots in ring order from the cursor: rank them with one
        # cumsum, invert rank -> ring offset with one scatter
        live_r = live_tab[((head + slot) % cap).long()]
        free_rank = torch.cumsum(i32(~live_r), 0, dtype=I32) - 1
        ring_of_rank = scatter_drop(
            torch.full((cap,), cap, dtype=I32, device=dev),
            torch.where(~live_r, free_rank, cap), slot)
        n_free = cap - live_tab.sum(dtype=I32)
        live_in = tenants >= 0
        j = torch.cumsum(i32(live_in), 0, dtype=I32) - 1
        ok = live_in & (j < n_free)
        dest_ring = ring_of_rank[j.clamp(0, cap - 1).long()]
        dest = (head + dest_ring.clamp(0, cap - 1)) % cap
        idx = torch.where(ok, dest, cap)
        old_order = state["order"]
        old_sg = state["sorted_gseg"]
        old_span = state["seg_start"][self.n_seg_total]
        old_live_s = live_tab[old_order.long()]
        state = dict(state)
        state["price"] = scatter_drop(state["price"], idx, prices)
        state["blimit"] = scatter_drop(state["blimit"], idx,
                                       torch.maximum(prices, limits))
        state["level"] = scatter_drop(state["level"], idx, levels)
        state["node"] = scatter_drop(state["node"], idx, nodes)
        state["tenant"] = scatter_drop(state["tenant"], idx, tenants)
        state["seq"] = scatter_drop(state["seq"], idx,
                                    state["next_seq"] + j)
        n_in = live_in.sum(dtype=I32)
        state["next_seq"] = state["next_seq"] + n_in
        n_used = ok.sum(dtype=I32)
        state["dropped"] = state["dropped"] + n_in - n_used
        state["head"] = torch.where(
            n_used > 0,
            (head + torch.where(ok, dest_ring, -1).max() + 1) % cap, head)
        # ---- sorted-view maintenance (docs/DESIGN.md §10): a full sort
        # when the view's dead fraction passed resort_dead_frac (one
        # host read), else merge the sorted batch into the live view
        dead_frac = (old_span - live_tab.sum(dtype=I32)).to(F32) \
            / torch.clamp_min(old_span, 1).to(F32)
        if not self.incremental_sort \
                or bool(dead_frac > self.resort_dead_frac):
            return self._resort(state)
        live_b = ok & (prices > NEG / 2)
        gseg_b = self._gseg_of(levels, nodes, live_b)
        # batch sort by (gseg asc, price desc, batch position asc): the
        # position key is the identity order, so one stable sort on the
        # (gseg, price order key) pair does it
        neg_key = f32_order_key(
            torch.neg(torch.where(live_b, prices, NEG))).long() + (1 << 31)
        perm = torch.sort((gseg_b.long() << 32) | neg_key,
                          stable=True).indices
        state["order"], state["sorted_gseg"], state["seg_start"] = \
            self._merged_view(state, old_order, old_sg, old_live_s,
                              gseg_b[perm],
                              torch.where(live_b, dest, 0)[perm],
                              live_b.sum(dtype=I32))
        return state

    def cancel_all(self, state):
        """Kill every resting order and reset the view to the empty one
        (as ``init_state`` has it), so the next ``place`` merges instead
        of resorting a fully dead span."""
        cap, dev = self.capacity, self.device
        state = dict(state)
        state["price"] = torch.full_like(state["price"], NEG)
        state["tenant"] = torch.full_like(state["tenant"], -1)
        state["order"] = arange32(cap, dev)
        state["sorted_gseg"] = torch.full((cap,), self.n_seg_total,
                                          dtype=I32, device=dev)
        state["seg_start"] = torch.zeros_like(state["seg_start"])
        return state

    def cancel(self, state, bid_ids):
        """Deactivate bid slots (negative ids count from the end, ids out
        of range are ignored).  A kill keeps the sorted view valid."""
        cap = self.capacity
        ids = bid_ids.long()
        ids = torch.where(ids < 0, ids + cap, ids)
        state = dict(state)
        state["price"] = scatter_drop(state["price"], ids, NEG)
        state["tenant"] = scatter_drop(state["tenant"], ids, -1)
        return state

    def set_health(self, state, levels, nodes, values):
        """Batched failure-domain health update: every leaf under node
        ``nodes[i]`` at level ``levels[i]`` gets ``values[i]``
        (``values < 0`` is padding; on overlap the later entry wins)."""
        m = levels.shape[0]
        if m == 0:
            return state
        tree = self.tree
        leaf = arange32(tree.n_leaves, self.device)
        live = values >= 0
        lvl = levels.clamp(0, tree.n_levels - 1).long()
        anc = leaf[None, :] // self._strides[lvl][:, None]
        cover = live[:, None] & (anc == nodes[:, None])
        idx = arange32(m, self.device)
        last = torch.amax(torch.where(cover, idx[:, None], -1), dim=0)
        health = torch.where(last >= 0,
                             values[last.clamp(0, m - 1).long()],
                             state["health"]).to(I32)
        state = dict(state)
        state["health"] = health
        return state

    # ------------------------------------------------------------------
    def _clear_arrays(self, state):
        """One clearing pass over the sorted view (``ops.clear``)."""
        return clear_ops.clear(
            state["order"], state["sorted_gseg"], state["seg_start"],
            state["price"], state["tenant"], state["seq"],
            tuple(state["floor"]), self.level_off, self.tree.strides,
            state["owner"], state["limit"], self.k,
            health=state["health"])

    def _clip_bids(self, state, prices, levels, nodes):
        """Volatility control: clip each bid to max_bid_multiple x its
        scope's reference price (max of path floors, top of the scope's
        own book, charged rates under the scope); a zero reference
        disables clipping."""
        mult = self.controls.max_bid_multiple
        if mult <= 0:
            return prices
        tree, dev = self.tree, self.device
        first_leaf = nodes * _take(self._strides, levels)
        leaf_ids = torch.arange(tree.n_leaves, device=dev)
        live = (state["price"] > NEG / 2) & (state["tenant"] >= 0)
        ref = torch.zeros(prices.shape, dtype=F32, device=dev)
        for d2, s2 in enumerate(tree.strides):
            n_d = tree.nodes_at(d2)
            anc = (first_leaf // s2).clamp(0, n_d - 1).long()
            # path floors (ancestors of the scope: levels >= scope's)
            f = state["floor"][d2][anc]
            ref = torch.maximum(ref, torch.where(d2 >= levels, f, 0.0))
            # top of the scope's own book
            seg = state["node"].clamp(0, n_d - 1).long()
            at_d2 = live & (state["level"] == d2)
            top_d2 = torch.full((n_d,), NEG, dtype=F32, device=dev) \
                .scatter_reduce(0, seg, torch.where(at_d2, state["price"],
                                                    NEG),
                                "amax", include_self=True)
            nsel = nodes.clamp(0, n_d - 1).long()
            top = top_d2[nsel]
            ref = torch.maximum(ref, torch.where(
                (d2 == levels) & (top > NEG / 2), top, 0.0))
            # max charged rate among leaves under the scope
            rmax_d2 = torch.zeros((n_d,), dtype=F32, device=dev) \
                .scatter_reduce(0, leaf_ids // s2, state["rate"], "amax",
                                include_self=True)
            ref = torch.maximum(ref, torch.where(
                d2 == levels, rmax_d2[nsel], 0.0))
        return torch.where(ref > 0, torch.minimum(prices, ref * mult),
                           prices)

    # ------------------------------------------------------------------
    def _cascade(self, state, t, release):
        """Clear / evict / transfer to fixpoint.  Each wave is one
        clearing pass and up to K claim rounds; the wave loop and the
        round loop run on the host, one device read per check."""
        tree = self.tree
        n_leaves = tree.n_leaves
        K = self.k
        cap = self.capacity
        dev = self.device
        leafid = arange32(n_leaves, dev)
        min_hold = self.controls.min_holding_s
        # path floors are cascade-invariant: hoist the per-leaf combine
        floor_leaf = R.leaf_floor(state["floor"], tree.strides, n_leaves,
                                  dev)

        def wave(st, rel):
            rate, _lvl, cands, trunc, evict_p = self._clear_arrays(st)
            st = dict(st)
            st["rate"] = rate
            st["waves"] = st["waves"] + 1
            owner = st["owner"]
            evict = evict_p != 0
            if min_hold > 0:
                evict = evict & ((t - st["acq_t"]) >= min_hold)
            trunc_b = trunc != 0
            # the slate holds -1 HOLES: "has a candidate" is any(>= 0)
            has_cand = torch.any(cands >= 0, dim=-1)
            sell = (owner < 0) & has_cand        # idle supply matching
            # idle supply first: while a marketable bid can still fill
            # an idle leaf, its pressure must not evict anyone
            sell_pending = torch.any(sell)
            evict = evict & ~sell_pending
            releasing = rel & (owner >= 0) & ~sell_pending
            unresolved0 = evict | releasing | sell
            # an exhausted slate is conclusive when it was complete or
            # empty at wave start; otherwise the leaf needs a re-clear
            conclusive = ~trunc_b | ~has_cand
            price_tab = st["price"]
            tenant_tab = st["tenant"]
            blimit_tab = st["blimit"]
            cexp = cands.clamp(0, cap - 1).long()    # (n_leaves, K')

            def round_one(rc):
                (owner_c, limit_c, acq_c, consumed, unresolved, moved,
                 go) = rc
                # each unresolved leaf's best not-yet-consumed entry
                okj = (cands >= 0) & ~consumed[cexp]
                found = torch.any(okj, dim=-1)
                first = torch.argmax(i32(okj), dim=-1)
                prop = torch.where(
                    unresolved & found,
                    torch.gather(cands, 1, first[:, None])[:, 0], -1)
                ps = prop.clamp(0, cap - 1).long()
                # an evicted leaf re-checks its limit against the
                # fall-through price
                floor_evicts = floor_leaf > limit_c + EPSF
                evict_still = floor_evicts | \
                    ((prop >= 0) & (price_tab[ps] > limit_c + EPSF))
                lapsed_raw = unresolved & evict & ~releasing & ~sell \
                    & (prop >= 0) & ~evict_still
                active = unresolved & ~lapsed_raw
                exhausted = active & (prop < 0)
                # exhausting a truncated slate freezes the wave
                go = go & ~torch.any(exhausted & ~conclusive)
                lapsed = lapsed_raw & go
                act = active & (prop >= 0) & go
                # OCO within a round: the lowest claiming leaf wins
                claimer = torch.full((cap + 1,), n_leaves, dtype=I32,
                                     device=dev).scatter_reduce(
                    0, torch.where(act, prop, cap).long(),
                    torch.where(act, leafid, n_leaves), "amin",
                    include_self=True)[:cap]
                win = act & (claimer[ps] == leafid)
                consumed = consumed | (claimer < n_leaves)
                # conclusively exhausted movers fall back to the operator
                done = exhausted & conclusive & go
                recl = done & (releasing | (evict & floor_evicts))
                moved_r = win | recl
                owner_c = torch.where(
                    win, tenant_tab[ps], torch.where(recl, -1, owner_c))
                limit_c = torch.where(
                    win, blimit_tab[ps],
                    torch.where(recl, float("inf"), limit_c))
                acq_c = torch.where(moved_r, t, acq_c)
                # a reclaim makes new idle supply: freeze the rest
                go = go & ~torch.any(recl)
                return (owner_c, limit_c, acq_c, consumed,
                        unresolved & ~moved_r & ~lapsed & ~done,
                        moved | moved_r, go)

            rc = (st["owner"], st["limit"], st["acq_t"],
                  torch.zeros(cap, dtype=torch.bool, device=dev),
                  unresolved0,
                  torch.zeros(n_leaves, dtype=torch.bool, device=dev),
                  torch.ones((), dtype=torch.bool, device=dev))
            if K == 1:
                rc = round_one(rc)
            else:
                r = 0
                while r < K and bool(rc[6] & torch.any(rc[4])):
                    rc = round_one(rc)
                    r += 1
            st["owner"], st["limit"], st["acq_t"], consumed, _, moved, \
                _ = rc
            # consume winning orders (a kill keeps the view valid)
            st["price"] = torch.where(consumed, NEG, st["price"])
            st["tenant"] = torch.where(consumed, -1, st["tenant"])
            return st, rel & ~moved, torch.any(moved)

        while True:
            state, release, any_moved = wave(state, release)
            if not bool(any_moved):
                return state

    # ------------------------------------------------------------------
    def step(self, state, t, new_bids=None, floor_updates=None,
             relinquish=None, limits=None):
        """One market epoch at time ``t``.

        new_bids: optional dict of (b,) tensors ``price``, ``limit``,
            ``level``, ``node``, ``tenant`` (tenant -1 = padding).
        floor_updates: optional per-level proposals (< 0 = no change).
        relinquish: optional (m,) int32 leaf ids to release (-1 pad).
        limits: optional (n_leaves,) float32 retention limits (NaN =
            unchanged), applied before this step's events.
        Returns ``(state, transfers, bills)``."""
        tree, dev = self.tree, self.device
        state = dict(state)
        state["floor"] = tuple(state["floor"])
        state["floor_t"] = tuple(state["floor_t"])
        t = torch.as_tensor(t, dtype=F32, device=dev)
        # 1) integral billing accrual at the previous step's rates, each
        #    tenant's leaves added in leaf order (deterministic)
        dt_h = torch.clamp_min(t - state["t"], 0.0) * PER_HOUR
        owner0 = state["owner"]
        bill_idx = torch.where(owner0 >= 0, owner0, self.n_tenants)
        state["bills"] = seq_scatter_add(
            state["bills"], bill_idx,
            torch.where(owner0 >= 0, state["rate"] * dt_h, 0.0))
        state["t"] = t
        # 1b) owners on DOWN leaves are force-evicted after the accrual
        fault_evict = (state["health"] == HEALTH_DOWN) & (owner0 >= 0)
        state["owner"] = torch.where(fault_evict, -1, state["owner"])
        state["limit"] = torch.where(fault_evict, float("inf"),
                                     state["limit"])
        no_release = torch.zeros(tree.n_leaves, dtype=torch.bool,
                                 device=dev)
        # 2) deferred min-holding evictions matured by time passage
        if self.controls.min_holding_s > 0:
            state = self._cascade(state, t, no_release)
        # 2b) retention-limit refresh (NaN = no change), owned leaves only
        if limits is not None:
            state["limit"] = torch.where(
                torch.isnan(limits) | (state["owner"] < 0),
                state["limit"], limits)
        # 3) operator floor updates, drops bounded by floor_fall_rate
        if floor_updates is not None:
            fall = self.controls.floor_fall_rate
            floors, floor_ts = [], []
            for d in range(tree.n_levels):
                prop = floor_updates[d]
                old = state["floor"][d]
                upd = prop >= 0.0
                if fall > 0:
                    # 1 - fall * dt_s / 3600 as the reference computes
                    # it: the two constants fold into one float32
                    # factor, fused into the subtraction
                    dt_s = torch.clamp_min(t - state["floor_t"][d], 0.0)
                    rate_s = float(np.float32(fall) * np.float32(PER_HOUR))
                    min_allowed = old * torch.clamp_min(
                        fma(-dt_s, rate_s, 1.0), 0.0)
                    val = torch.where(prop < old,
                                      torch.maximum(prop, min_allowed),
                                      prop)
                else:
                    val = prop
                floors.append(torch.where(upd, val, old))
                floor_ts.append(torch.where(upd, t, state["floor_t"][d]))
            state["floor"] = tuple(floors)
            state["floor_t"] = tuple(floor_ts)
        # 4) admit new bids (clipped)
        if new_bids is not None:
            prices = self._clip_bids(state, new_bids["price"],
                                     new_bids["level"], new_bids["node"])
            state = self.place(state, prices, new_bids["level"],
                               new_bids["node"], new_bids["tenant"],
                               new_bids.get("limit"))
        # 5) explicit relinquishments + clear/evict/transfer cascade
        release = no_release
        if relinquish is not None:
            hits = scatter_add_drop(
                tree.n_leaves,
                torch.where(relinquish >= 0, relinquish, tree.n_leaves),
                torch.ones(relinquish.shape, dtype=I32, device=dev))
            release = hits > 0
        state = self._cascade(state, t, release)
        transfers = {"moved": owner0 != state["owner"], "old": owner0,
                     "new": state["owner"],
                     "revoked_by_fault": fault_evict}
        return state, transfers, state["bills"]


def build_tree(n_leaves: int, gpus_per_host: int = 8,
               hosts_per_rack: int = 4, racks_per_zone: int = 4) -> TreeSpec:
    s_host = gpus_per_host
    s_rack = s_host * hosts_per_rack
    s_zone = s_rack * racks_per_zone
    return TreeSpec(n_leaves=n_leaves,
                    strides=(1, s_host, s_rack, s_zone, n_leaves))
