"""Seeded deterministic fault injection for the batch market — the twin
of ``repro.sim.faults`` (docs/DESIGN.md §11).

A ``FaultInjector`` holds a time-sorted schedule of :class:`FaultEvent`
records — failure-domain ``fail``/``repair``/``drain`` transitions at
any tree level, plus ``crash`` kill-points, carried here as data only —
and applies everything due at a tick as ONE batched
``BatchEngine.set_health`` scatter before that tick's epoch.  Fault-free
ticks cost a host-side pointer check and no device work.

Events at equal times apply in schedule order (``sorted`` is stable,
and ``set_health`` resolves overlapping domains in one batch as
later-entry-wins).  ``rewind_to(t)`` repositions the consumption
pointer: a state taken after the epoch at ``t`` already holds every
event with ``event.t <= t``, so replay resumes from the first strictly
later event.

The fleet needs no fault-specific code: a force-evicted tenant sees its
leaves vanish as involuntary losses in ``Fleet.after_step``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.market_torch.engine import (HEALTH_DOWN, HEALTH_DRAINING,
                                             HEALTH_UP, TreeSpec)

_EPS = 1e-9

# event kind -> health value scattered over the domain's leaf range
_KIND_VALUE = {"fail": HEALTH_DOWN, "repair": HEALTH_UP,
               "drain": HEALTH_DRAINING}

# default build_tree level indices (strides (1, host, rack, zone, root))
LEVEL_LEAF, LEVEL_HOST, LEVEL_RACK, LEVEL_ZONE = 0, 1, 2, 3


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``kind`` is ``fail``/``repair``/``drain``
    (failure-domain health transitions: ``node`` at tree ``level``) or
    ``crash`` (a process kill-point; ``phase`` names the boundary)."""
    t: float
    kind: str
    level: int = 0
    node: int = 0
    phase: str = "post_wal"

    def __post_init__(self):
        if self.kind not in ("fail", "repair", "drain", "crash"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultInjector:
    """Deterministic schedule driver.  ``pad`` fixes the scatter batch
    shape (oversize ticks chunk)."""

    def __init__(self, events: Iterable[FaultEvent], pad: int = 64
                 ) -> None:
        evs = sorted(events, key=lambda e: e.t)     # stable: schedule
        self.health_events = [e for e in evs if e.kind != "crash"]
        self.crash_events = [e for e in evs if e.kind == "crash"]
        self.pad = int(pad)
        self._i = 0          # first unapplied health event
        self._c = 0          # first unconsumed crash event

    # ------------------------------------------------------------ health
    def due_health(self, t: float) -> List[FaultEvent]:
        """Consume and return every health event with ``event.t <= t``."""
        due: List[FaultEvent] = []
        while self._i < len(self.health_events) and \
                self.health_events[self._i].t <= t + _EPS:
            due.append(self.health_events[self._i])
            self._i += 1
        return due

    def apply_health(self, eng, state, t: float):
        """Apply all due health events to an engine state dict — one
        padded ``set_health`` scatter per ``pad``-sized chunk, nothing
        when the tick is fault-free."""
        due = self.due_health(t)
        if not due:
            return state
        for lo in range(0, len(due), self.pad):
            chunk = due[lo:lo + self.pad]
            levels = np.zeros((self.pad,), np.int32)
            nodes = np.zeros((self.pad,), np.int32)
            values = np.full((self.pad,), -1, np.int32)
            for j, e in enumerate(chunk):
                levels[j] = e.level
                nodes[j] = e.node
                values[j] = _KIND_VALUE[e.kind]
            state = eng.set_health(
                state, *(torch.from_numpy(a).to(eng.device)
                         for a in (levels, nodes, values)))
        return state

    def apply_market(self, market, rtype: str, t: float) -> None:
        """``apply_health`` against a ``BatchMarket``'s state."""
        market.states[rtype] = self.apply_health(
            market.engines[rtype], market.states[rtype], t)

    # ------------------------------------------------------------ crashes
    def due_crash(self, t: float, phase: Optional[str] = None
                  ) -> Optional[FaultEvent]:
        """Consume and return the next crash event due at ``t`` (None
        when the tick has no pending kill).  With ``phase``, only an
        event scheduled for that boundary is consumed."""
        if self._c < len(self.crash_events) and \
                self.crash_events[self._c].t <= t + _EPS:
            e = self.crash_events[self._c]
            if phase is None or e.phase == phase:
                self._c += 1
                return e
        return None

    # ------------------------------------------------------------ replay
    def rewind_to(self, t: float) -> None:
        """Resume consumption at the first health event strictly after
        ``t``; crash events up to ``t`` count as spent."""
        self._i = 0
        while self._i < len(self.health_events) and \
                self.health_events[self._i].t <= t + _EPS:
            self._i += 1
        self._c = 0
        while self._c < len(self.crash_events) and \
                self.crash_events[self._c].t <= t + _EPS:
            self._c += 1

    def reset(self) -> None:
        self._i = 0
        self._c = 0


# ---------------------------------------------------------------------------
# seeded schedule builders (all deterministic in (args, seed))
# ---------------------------------------------------------------------------
def rack_failure_storm(tree: TreeSpec, t0: float, duration_s: float,
                       period_s: float, repair_after_s: float,
                       racks_per_burst: int = 1, seed: int = 0,
                       level: int = LEVEL_RACK) -> List[FaultEvent]:
    """Periodic bursts of rack failures with delayed repairs: every
    ``period_s`` starting at ``t0``, ``racks_per_burst`` distinct racks
    go down and come back ``repair_after_s`` later."""
    rng = np.random.default_rng(seed)
    n_nodes = tree.nodes_at(level)
    events: List[FaultEvent] = []
    t = t0
    while t <= t0 + duration_s:
        picks = rng.choice(n_nodes, size=min(racks_per_burst, n_nodes),
                           replace=False)
        for node in picks:
            events.append(FaultEvent(t, "fail", level, int(node)))
            events.append(FaultEvent(t + repair_after_s, "repair",
                                     level, int(node)))
        t += period_s
    return events


def zone_supply_shock(t_fail: float, t_repair: float, zone: int = 0,
                      level: int = LEVEL_ZONE) -> List[FaultEvent]:
    """One whole zone's capacity leaves the market at ``t_fail`` and
    returns at ``t_repair``."""
    return [FaultEvent(t_fail, "fail", level, zone),
            FaultEvent(t_repair, "repair", level, zone)]


def drain_schedule(nodes: Sequence[Tuple[int, int]], t_drain: float,
                   t_up: Optional[float] = None) -> List[FaultEvent]:
    """Put ``(level, node)`` domains into draining (no new owners,
    existing retention honored) at ``t_drain``; optionally return them
    to service at ``t_up``."""
    events = [FaultEvent(t_drain, "drain", lv, nd) for lv, nd in nodes]
    if t_up is not None:
        events += [FaultEvent(t_up, "repair", lv, nd)
                   for lv, nd in nodes]
    return events


def crash_schedule(ticks: Sequence[float],
                   phases: Sequence[str]) -> List[FaultEvent]:
    """Kill-points: one ``crash`` event per (tick, phase) pair."""
    if len(ticks) != len(phases):
        raise ValueError("crash_schedule needs one phase per tick")
    return [FaultEvent(t, "crash", phase=ph)
            for t, ph in zip(ticks, phases)]
