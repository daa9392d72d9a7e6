"""Synthetic traces, copied from ``repro.sim.traces`` (docs/DESIGN.md
§7): inference load (diurnal sinusoid plus log-normal bursts and
occasional spikes on a 10 s tick) with the dense rate grid the fleet
reads, the two power rows of Fig 11, Poisson arrivals, and random
Market-API event traces for replaying one workload on several
markets."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np


def llm_request_rate(seed: int, duration_s: float, base_rps: float = 20.0,
                     tick_s: float = 10.0) -> Callable[[float], float]:
    """Azure-style serving load: diurnal + bursty (log-normal residuals)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / tick_s) + 2
    t = np.arange(n) * tick_s
    diurnal = 1.0 + 0.4 * np.sin(2 * math.pi * t / 86400.0
                                 + rng.uniform(0, 2 * math.pi))
    bursts = rng.lognormal(mean=0.0, sigma=0.35, size=n)
    # occasional 2-4x spikes (every ~20 min on average)
    spikes = np.ones(n)
    for i in range(n):
        if rng.random() < tick_s / 1200.0:
            spikes[i:i + int(120 / tick_s)] *= rng.uniform(2.0, 4.0)
    rate = base_rps * diurnal * bursts * spikes

    def f(now: float) -> float:
        i = min(int(now / tick_s), n - 1)
        return float(rate[i])
    return f


def power_rows(seed: int, duration_s: float, cap_kw: float = 100.0,
               tick_s: float = 10.0) -> Dict[str, Callable[[float], float]]:
    """Two cluster rows as separate power domains (Fig 11): row A ramps to
    a constrained level at t = 5 min; row B stays comfortable."""
    rng = np.random.default_rng(seed)
    n = int(duration_s / tick_s) + 2

    def row(base_frac: float, jump_at: float, jump_to: float):
        arr = np.full(n, base_frac * cap_kw)
        arr += rng.normal(0, 0.02 * cap_kw, size=n)
        j = n if not math.isfinite(jump_at) else int(jump_at / tick_s)
        if j < n:
            arr[j:] = jump_to * cap_kw + rng.normal(0, 0.02 * cap_kw,
                                                    size=n - j)

        def f(now: float) -> float:
            i = min(int(now / tick_s), n - 1)
            return float(max(arr[i], 0.0))
        return f

    return {"rowA": row(0.55, 300.0, 0.97),
            "rowB": row(0.50, math.inf, 0.50)}


def sample_rate_grid(rate_fns: List[Optional[Callable[[float], float]]],
                     duration_s: float, tick_s: float = 10.0) -> np.ndarray:
    """Per-tenant rate callables sampled onto one dense piecewise-constant
    ``(n_tenants, n_ticks)`` float32 grid; ``grid[i, min(int(t / tick_s),
    n_ticks - 1)]`` equals ``rate_fns[i](t)`` at any ``t``.  ``None``
    entries (training and batch tenants) sample as zeros."""
    n_ticks = int(duration_s / tick_s) + 2
    out = np.zeros((len(rate_fns), n_ticks), np.float32)
    for i, f in enumerate(rate_fns):
        if f is None:
            continue
        out[i] = [f(k * tick_s) for k in range(n_ticks)]
    return out


def poisson_arrivals(seed: int, duration_s: float, mean_interarrival_s: float
                     ) -> List[float]:
    """Arrival times of a Poisson process with the given mean gap, up to
    (not including) ``duration_s``."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    while True:
        t += rng.exponential(mean_interarrival_s)
        if t >= duration_s:
            return out
        out.append(t)


def market_trace(market, seed: int, n_events: int,
                 n_tenants: int = 5) -> List[tuple]:
    """A random Market-API event trace (``tests/test_differential.py``'s
    generator): operator floors of 2.0 at every root, then place (55%),
    floor (10%), relinquish (15%) and advance (20%) events over
    ``n_tenants`` tenants, each applied to ``market`` (an event
    ``Market``) as it is drawn — the market decides which leaves a
    relinquish can release.  Returns the events for ``apply_event``."""
    rng = np.random.default_rng(seed)
    topo = market.topo
    tenants = [f"t{i}" for i in range(n_tenants)]
    nodes = [n.node_id for n in topo.nodes]
    events = [("floor", root, 2.0) for root in topo.roots.values()]
    for e in events:
        apply_event(market, e)
    now = 0.0
    for _ in range(n_events):
        kind = rng.choice(["place", "floor", "relinquish", "advance"],
                          p=[0.55, 0.1, 0.15, 0.2])
        if kind == "place":
            t = tenants[rng.integers(len(tenants))]
            scope = nodes[rng.integers(len(nodes))]
            price = float(rng.uniform(0.5, 12.0))
            e = ("place", t, scope, price,
                 price * float(rng.uniform(1.0, 1.6)))
        elif kind == "floor":
            e = ("floor", nodes[rng.integers(len(nodes))],
                 float(rng.uniform(0.0, 8.0)))
        elif kind == "relinquish":
            t = tenants[rng.integers(len(tenants))]
            owned = sorted(market.owned_leaves(t))
            if not owned:
                continue
            e = ("relinquish", t, owned[rng.integers(len(owned))])
        else:
            now += float(rng.uniform(60.0, 1800.0))
            e = ("advance", now)
        apply_event(market, e)
        events.append(e)
    return events


def apply_event(market, event: tuple) -> None:
    """One ``market_trace`` event on any market with the Market API."""
    kind = event[0]
    if kind == "place":
        market.place_order(*event[1:4], limit=event[4])
    elif kind == "floor":
        market.set_floor(*event[1:])
    elif kind == "relinquish":
        market.relinquish(*event[1:])
    elif kind == "cancel":
        market.cancel_order(*event[1:])
    else:
        market.advance_to(event[1])
