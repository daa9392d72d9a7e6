"""BatchMarket: the fleet-facing part of ``repro.market_jax.bridge`` on
the PyTorch engine — one ``BatchEngine`` per resource type, its
``TreeSpec`` derived from the topology, and the array-native epoch
hooks the fleet drives (``leaf_view``, ``cancel_all``,
``step_arrays``, ``set_floor``, ``reset``).  Fleet tenant ids are
engine tenant ids.  The string-tenant order facade of the reference is
not ported here.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.core.market import VolatilityControls
from repro_torch.core.topology import Topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.market_torch.engine import BatchEngine, TreeSpec


class BatchMarket:
    """Per-resource-type batch engines over one topology."""

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
        self._node_map: Dict[int, tuple] = {}
        self.stats = {"orders": 0, "transfers": 0, "implicit_relinquish": 0,
                      "explicit_relinquish": 0, "cancels": 0,
                      "revoked_by_fault": 0}
        for rtype, root in topo.roots.items():
            self._build_tree(rtype, root, capacity)

    # ---------------------------------------------------------- layout
    def _build_tree(self, rtype: str, root: int, capacity: int) -> None:
        """Regular tree of one resource type: the stride at level d is
        the largest leaf count under a node of that level; topology
        nodes map to (rtype, level, first_leaf // stride)."""
        topo = self.topo
        leaves = topo.leaves_of(root)
        depth = max(len(topo.ancestors(leaf)) for leaf in leaves)
        if not all(len(topo.ancestors(leaf)) == depth for leaf in leaves):
            raise ValueError("BatchMarket needs uniform-depth trees")
        leaf_pos = {leaf: i for i, leaf in enumerate(leaves)}
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

    def _count(self, transfers, explicit=None) -> None:
        """Market stats of one step, as the reference counts them."""
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

    def step_arrays(self, rtype: str, t: float, bids=None,
                    relinquish=None, limits=None, explicit=None):
        """One engine epoch at ``t`` with a whole event batch; ``explicit``
        is the (n_leaves,) graceful-release mask.  Updates the stats and
        returns the transfers dict."""
        if t < self.now - 1e-9:
            raise ValueError(f"time went backwards: {t} < {self.now}")
        self.now = max(self.now, t)
        eng = self.engines[rtype]
        st, transfers, _ = eng.step(self.states[rtype], self.now, bids,
                                    None, relinquish, limits)
        self.states[rtype] = st
        if bids is not None:
            self.stats["orders"] += int((bids["tenant"] >= 0).sum())
        self._count(transfers, explicit)
        return transfers

    def reset(self) -> None:
        """Fresh engine state (same layout); floors must be re-seeded."""
        for rtype, eng in self.engines.items():
            self.states[rtype] = eng.init_state()
        self.now = 0.0
        self.stats = {k: 0 for k in self.stats}

    # ----------------------------------------------------------- operator
    def set_floor(self, node: int, price: float) -> None:
        """Propose an operator floor at one topology node and step."""
        rtype, d, idx = self._node_map[node]
        eng = self.engines[rtype]
        floors = [torch.full((eng.tree.nodes_at(lvl),), -1.0,
                             dtype=torch.float32, device=self.device)
                  for lvl in range(eng.tree.n_levels)]
        floors[d][idx] = price
        st, transfers, _ = eng.step(self.states[rtype], self.now, None,
                                    tuple(floors), None)
        self.states[rtype] = st
        self._count(transfers)
