"""Synthetic inference-load traces, copied from ``repro.sim.traces``:
diurnal sinusoid plus log-normal bursts and occasional spikes on a 10 s
tick (docs/DESIGN.md §7), and the dense rate grid the fleet reads."""
from __future__ import annotations

import math
from typing import Callable, List, Optional

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
