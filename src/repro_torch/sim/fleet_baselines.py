"""Fleet-scale baseline allocators on the PyTorch fleet — the twin of
``repro.sim.fleet_baselines``: fcfs / fcfsp / spot at 10k leaves.

The allocators are host-numpy passes over a per-leaf owner array, as in
the reference; everything that decides performance is the same torch
``Fleet`` the laissez runs use, on its device: ``desired_nodes``
(autoscaler), ``after_step`` (reconfiguration windows, cold starts,
wasted work on forced revocation), ``advance`` (serving / progress),
``apply_policy_log`` (the scale-down hysteresis stamp) and, for spot,
``listing1`` (launch-bid quotes).  Swapping only the allocator is the
paper's §5.1 isolation at fleet scale (docs/DESIGN.md §13).

Owner-array convention matches ``Fleet.after_step``: ``(n_leaves,)``
int32, tenant index in ``[0, n)`` when held, ``-1`` when free.

These runs clear no book.  The reference seeds the market's floors (one
engine step) before computing the denominator; every engine-alone run
resets the market and seeds them again, so that step changes nothing
and is left out here, and a baseline launches the clearing kernel only
in the alone runs of a denominator not yet cached.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.sim.cloud import SpotBook
from repro_torch.sim.workloads import KIND_IDS, ON_DEMAND

KIND_INFER = KIND_IDS["inference"]

HYSTERESIS_S = 120.0         # Tenant scale-down hysteresis (FleetConfig)
PREEMPT_COOLDOWN_S = 120.0   # FCFSPCloud rate limit (reference sim/cloud.py)
SPOT_FLOOR_FRAC = 0.7        # SpotCloud.floor_frac
BASELINES = ("fcfs", "fcfsp", "spot")


def _release_surplus(owner: np.ndarray, want: np.ndarray,
                     held: np.ndarray, last_scale_down: np.ndarray,
                     now: float, sel: np.ndarray) -> None:
    """Graceful surplus release under the shared 120 s hysteresis:
    highest-index leaves first (the deterministic tie-break).  Marks
    ``sel`` and frees ``owner`` in place."""
    extra = held - want
    eligible = (now - last_scale_down >= HYSTERESIS_S) & (extra > 0)
    for i in np.nonzero(eligible)[0]:
        leaves = np.nonzero(owner == i)[0]
        for leaf in leaves[::-1][: extra[i]]:
            owner[leaf] = -1
            sel[leaf] = True


def _drive(kind: str, fleet, params, fcfg) -> Tuple[dict, Dict[str, int]]:
    """Run one multi-tenant fleet scenario under baseline ``kind``."""
    dev = fleet.device
    n = fleet.cfg.n
    n_leaves = fleet.tree.n_leaves
    state = fleet.init_state(params)
    owner = np.full(n_leaves, -1, np.int32)
    arrival = params["arrival_s"].cpu().numpy()
    kinds = params["kind"].cpu().numpy()
    order = np.argsort(arrival, kind="stable")       # FCFS arrival order
    last_preempt = np.full(n, -np.inf)
    stats = {"grants": 0, "preemptions": 0, "releases": 0,
             "requests": 0}
    book = None
    if kind == "spot":
        book = SpotBook(range(n_leaves),
                        ON_DEMAND.get("H100", 2.0) * SPOT_FLOOR_FRAC)

    def on_dev(a):       # a copy: the host arrays change next epoch
        return torch.tensor(a, device=dev)

    t = 0.0
    while t <= fcfg.duration_s:
        owner_b = owner.copy()
        sel = np.zeros(n_leaves, bool)
        want = fleet.desired_nodes(params, state, t).cpu().numpy()
        held = np.bincount(owner[owner >= 0], minlength=n)
        _release_surplus(owner, want, held,
                         state["last_scale_down"].cpu().numpy(), t, sel)
        stats["releases"] += int(sel.sum())
        if book is not None:
            for leaf in np.nonzero(sel)[0]:
                book.release(int(leaf))
        held = np.bincount(owner[owner >= 0], minlength=n)
        deficit = np.maximum(want - held, 0)
        deficit[arrival > t] = 0

        if kind in ("fcfs", "fcfsp"):
            free = list(np.nonzero(owner < 0)[0])
            for i in order:
                take = min(deficit[i], len(free))
                for _ in range(take):
                    owner[free.pop(0)] = i
                deficit[i] -= take
                stats["grants"] += take
            if kind == "fcfsp":
                # inference preempts training/batch, coarse victim
                # choice, rate-limited (FCFSPCloud._preempt)
                for i in order:
                    if deficit[i] <= 0 or kinds[i] != KIND_INFER:
                        continue
                    if t - last_preempt[i] < PREEMPT_COOLDOWN_S:
                        continue
                    last_preempt[i] = t
                    vmask = (owner >= 0) & (kinds[np.clip(owner, 0, n - 1)]
                                            != KIND_INFER)
                    victims = np.nonzero(vmask)[0][: deficit[i]]
                    owner[victims] = i          # forced: sel stays False
                    deficit[i] -= len(victims)
                    stats["preemptions"] += len(victims)
                    stats["grants"] += len(victims)
        else:
            # spot: Listing-1 launch bids against the current clearing
            # price, frozen at request time, one-shot requests
            spot = torch.tensor(book.spot, dtype=torch.float32, device=dev)
            price = fleet.listing1(
                params, state, on_dev(held.astype(np.int32)), spot,
                spot)[0].cpu().numpy()
            cap = fleet.cfg.per_tenant_bids
            for i in order:
                k = min(deficit[i], cap)
                if k <= 0 or price[i] <= 0 \
                        or price[i] < book.floor - 1e-9:
                    continue
                for _ in range(k):
                    book.request(int(i), float(price[i]))
                stats["requests"] += k
            grants, preempts = book.clear(t)
            for tid, leaf in preempts:
                owner[leaf] = -1                # forced: sel stays False
                stats["preemptions"] += 1
            for tid, leaf, _bid in grants:
                owner[leaf] = tid
                stats["grants"] += 1

        ob, sel_d = on_dev(owner_b), on_dev(sel)
        state = fleet.apply_policy_log(state, t, ob, sel_d)
        state, held_d = fleet.after_step(params, state, t, ob,
                                         on_dev(owner), sel_d)
        state = fleet.advance(params, state, t, held_d)
        t += fcfg.tick_s
    return state, stats


def run_fleet_baseline(kind: str, fcfg, device: DeviceLike = None):
    """Multi-tenant baseline run + the scenario's configured alone
    denominator => fleet-scale retention, comparable with
    ``run_fleet_scenario``'s laissez rows (same denominator modes), on
    ``device`` (``None`` = CUDA)."""
    from repro_torch.sim.simulator import (FleetRunResult, _alone_perf,
                                           _check_alone, make_fleet)
    if kind not in BASELINES:
        raise ValueError(f"unknown fleet baseline: {kind!r}")
    _check_alone(fcfg.alone)
    topo, _tenants, market, fleet, params = make_fleet(fcfg, device)
    state, stats = _drive(kind, fleet, params, fcfg)
    perf = fleet.performance(params, state, fcfg.duration_s).cpu().numpy()
    waves = []
    t0 = time.perf_counter()
    alone = _alone_perf(fleet, params, market, topo, fcfg, waves)
    alone_s = time.perf_counter() - t0
    retention = np.minimum(1.5, perf / np.maximum(alone, 1e-9))
    return FleetRunResult(perf=perf, alone_perf=alone,
                          retention=retention, epoch_s=[],
                          stats={k: float(v) for k, v in stats.items()},
                          alone_s=alone_s, alone_waves=waves)
