"""The fleet renegotiation epoch on the PyTorch engine — the twin of
``repro.sim.epoch`` (docs/DESIGN.md §10):

    policy -> cancel_all -> step (place/clear/evict/transfer/bill)
           -> stats -> after_step -> advance

The reference fuses the epoch into one donated jitted dispatch; here it
is a plain method over the same building blocks in the same order, and
``drive`` is a host loop.  The per-epoch stats stay device counters
until the run ends.  On CUDA each epoch ends in
``torch.cuda.synchronize()`` so that its wall time is the card's.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

STAT_KEYS = ("orders", "transfers", "explicit_relinquish",
             "implicit_relinquish", "bids_clipped", "revoked_by_fault")


def _isum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=torch.int32)


class EpochRunner:
    """Epoch driver bound to a (market, fleet, rtype) triple."""

    def __init__(self, market, fleet, rtype: str = "H100") -> None:
        self.market = market
        self.fleet = fleet
        self.rtype = rtype
        self.eng = market.engines[rtype]

    def epoch(self, params, eng_state, fleet_state, stats, t):
        """One fleet epoch at time ``t``; returns the advanced
        ``(eng_state, fleet_state, stats)``."""
        eng, fleet = self.eng, self.fleet
        owner_b = eng_state["owner"]
        limits, relinq, sel, bids, fleet_state, info = fleet.policy(
            params, fleet_state, t, owner_b, eng_state["rate"],
            tuple(eng_state["floor"]))
        eng_state = eng.cancel_all(eng_state)
        eng_state, transfers, _bills = eng.step(
            eng_state, t, bids, None, relinq, limits)
        moved = transfers["moved"]
        taken = moved & (transfers["new"] >= 0)
        stats = dict(stats)
        stats["orders"] = stats["orders"] + _isum(bids["tenant"] >= 0)
        stats["transfers"] = stats["transfers"] + _isum(taken)
        stats["explicit_relinquish"] = stats["explicit_relinquish"] \
            + _isum(moved & sel)
        stats["implicit_relinquish"] = stats["implicit_relinquish"] \
            + _isum(taken & ~sel & (transfers["old"] >= 0))
        stats["bids_clipped"] = stats["bids_clipped"] \
            + info["bids_clipped"].to(torch.int32)
        stats["revoked_by_fault"] = stats["revoked_by_fault"] \
            + _isum(transfers["revoked_by_fault"])
        fleet_state, held = fleet.after_step(
            params, fleet_state, t, owner_b, eng_state["owner"], sel)
        fleet_state = fleet.advance(params, fleet_state, t, held)
        return eng_state, fleet_state, stats

    def _sync(self) -> None:
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize(self.eng.device)

    def drive(self, params, fleet_state, duration_s: float, tick_s: float
              ) -> Tuple[dict, List[float], Dict[str, int]]:
        """Run epochs over [0, duration_s] at tick_s cadence from the
        market's engine state, then publish the final state and the
        accumulated stats back onto the market.  Returns the fleet
        state, each epoch's wall seconds and the stats."""
        market, rtype = self.market, self.rtype
        est = dict(market.states[rtype])
        est["floor"] = tuple(est["floor"])
        est["floor_t"] = tuple(est["floor_t"])
        stats = {k: torch.zeros((), dtype=torch.int32,
                                device=self.eng.device) for k in STAT_KEYS}
        epoch_s: List[float] = []
        t = 0.0
        while t <= duration_s:
            t0 = time.perf_counter()
            est, fleet_state, stats = self.epoch(params, est, fleet_state,
                                                 stats, t)
            self._sync()
            epoch_s.append(time.perf_counter() - t0)
            t += tick_s
        market.states[rtype] = est
        market.now = max(market.now, t - tick_s)
        host_stats = {k: int(stats[k]) for k in STAT_KEYS}
        for k in ("orders", "transfers", "explicit_relinquish",
                  "implicit_relinquish", "revoked_by_fault"):
            market.stats[k] += host_stats[k]
        return fleet_state, epoch_s, host_stats
