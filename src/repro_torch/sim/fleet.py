"""Vectorized tenant fleet on PyTorch tensors — the twin of
``repro.sim.fleet`` (same formulas, same results).

One ``Fleet`` holds every tenant's state as dense tensors (kind, work,
progress, deadline, reconfiguration window, checkpoint clock, EWMA
load), and one epoch is three calls: ``policy`` (the Listing-1 bid
batch, relinquish set and retention limits as the tensors
``BatchEngine.step`` takes), ``after_step`` (grant and revoke effects
from the engine's per-leaf transfers) and ``advance`` (workload
dynamics).  The v1 fidelity contract and its simplifications are the
reference's (see its module docstring).

The reference runs on XLA's CPU backend, which fuses float32
multiply-adds into FMA instructions; the formulas below use ``fma``
exactly where that fusion changes the rounding, so results stay
bit-identical on both devices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.device import (DeviceLike, arange32, f32_order_key, fma,
                                i32, recip32, resolve_device,
                                scatter_add_drop, scatter_drop)
from repro_torch.market_torch.engine import TreeSpec
from repro_torch.sim import traces
from repro_torch.sim.workloads import KIND_IDS, Tenant

KIND_INFER = KIND_IDS["inference"]

# SLA credit fraction exposed by inference tenants (P99 -> 10% + P999 ->
# 25% service credits)
_SLA_CREDITS = 0.10 + 0.25

F32 = torch.float32
I32 = torch.int32
PER_HOUR = recip32(3600.0)   # seconds -> hours, as the reference rounds it


def params_from_tenants(tenants: Sequence[Tenant], duration_s: float,
                        rate_tick_s: float = 10.0,
                        device: DeviceLike = None
                        ) -> Dict[str, torch.Tensor]:
    """The fleet's per-tenant parameter tensors plus the dense
    ``(n, T)`` inference-rate grid, from ``Tenant`` objects."""
    dev = resolve_device(device)

    def floats(xs):
        return torch.from_numpy(np.asarray(xs, np.float32)).to(dev)

    def ints(xs):
        return torch.from_numpy(np.asarray(xs, np.int32)).to(dev)
    rates = traces.sample_rate_grid(
        [t.p.rate_fn for t in tenants], duration_s, tick_s=rate_tick_s)
    return {
        "kind": ints([KIND_IDS[t.p.kind] for t in tenants]),
        "work": floats([t.p.work for t in tenants]),
        "deadline_s": floats([t.p.deadline_s for t in tenants]),
        "checkpoint_interval_s": floats([t.p.checkpoint_interval_s
                                      for t in tenants]),
        "reconfig_s": floats([t.p.reconfig_s for t in tenants]),
        "max_nodes": ints([t.p.max_nodes for t in tenants]),
        "cap_per_node": floats([t.p.cap_per_node for t in tenants]),
        "sla_value_per_h": floats([t.p.sla_value_per_h for t in tenants]),
        "value_per_gap": floats([t.p.value_per_gap for t in tenants]),
        "arrival_s": floats([t.arrival_s for t in tenants]),
        "overhead_mult": floats([t.overhead_mult for t in tenants]),
        "rates": torch.from_numpy(rates).to(dev),
    }


def params_alone(params: Dict[str, torch.Tensor], i: int
                 ) -> Dict[str, torch.Tensor]:
    """Counterfactual params where only tenant ``i`` ever arrives."""
    n = params["arrival_s"].shape[0]
    mask = torch.arange(n, device=params["arrival_s"].device) == i
    out = dict(params)
    out["arrival_s"] = torch.where(mask, params["arrival_s"],
                                   float("inf"))
    return out


@dataclass(frozen=True)
class FleetConfig:
    """Static fleet knobs."""
    n: int                           # number of tenants
    rate_tick_s: float = 10.0        # rate-grid tick (traces default)
    b_max: int = 1024                # bid-batch capacity per epoch
    per_tenant_bids: int = 8         # grow bids per tenant per epoch
    hysteresis_s: float = 120.0      # Tenant scale-down hysteresis
    horizon_h: float = 1.0           # AdapterConfig.horizon_h
    reconfig_estimate_mult: float = 1.0   # Fig 15 misestimation knob


def _count(n: int, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int32 ``zeros(n).at[idx].add(mask)``."""
    return scatter_add_drop(n, idx, i32(mask))


class Fleet:
    """Orchestration over the fleet tensors.

    Per-epoch contract (docs/DESIGN.md §8): the bids dict holds
    ``price/limit`` f32 and ``level/node/tenant`` i32 of shape
    ``(b_max,)`` with ``tenant == -1`` as padding; relinquish is
    ``(n_leaves,)`` i32 leaf ids padded with -1; limits is
    ``(n_leaves,)`` f32 with NaN where unchanged."""

    def __init__(self, cfg: FleetConfig, tree: TreeSpec,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg
        self.tree = tree
        self.device = resolve_device(device)

    def _now(self, now) -> torch.Tensor:
        return torch.as_tensor(now, dtype=F32, device=self.device)

    # ------------------------------------------------------------ state
    def init_state(self, params) -> Dict[str, torch.Tensor]:
        arr = params["arrival_s"]
        n = self.cfg.n
        dev = self.device

        def full(v):
            return torch.full((n,), v, dtype=F32, device=dev)
        return {
            "progress": full(0.0), "served": full(0.0),
            "demanded": full(0.0), "rate_ewma": full(0.0),
            "reconfig_until": full(-1.0),
            "last_checkpoint": arr.clone(), "last_t": arr.clone(),
            "last_scale_down": arr.clone(),
            "done_at": full(float("inf")),
            # inference cold-start batch (docs/DESIGN.md §13)
            "cold_cnt": full(0.0),
            "cold_until": full(-1.0),
        }

    # ------------------------------------------------------ rate lookup
    def _lam(self, params, t):
        """Piecewise-constant rate lookup ``rates[i, min(int(t / tick),
        T - 1)]``; ``t`` is a scalar or a per-tenant vector."""
        rates = params["rates"]
        T = rates.shape[1]
        # clamping in float before the cast equals the reference's cast
        # then clip for every finite t
        idx = (t * recip32(self.cfg.rate_tick_s)).clamp(0, T - 1) \
            .to(I32).long()
        idx = torch.broadcast_to(idx, (self.cfg.n,))
        return torch.gather(rates, 1, idx[:, None])[:, 0]

    # --------------------------------------------------------- dynamics
    def advance(self, params, state, now, held):
        """Vectorized ``Tenant.advance``: one tick of workload dynamics
        given the held-node counts."""
        p, s = params, dict(state)
        now = self._now(now)
        heldf = held.to(F32)
        dt = now - s["last_t"]
        tick = dt > 0
        done = torch.isfinite(s["done_at"])
        live = tick & (now >= p["arrival_s"]) & ~done
        ru = s["reconfig_until"]
        active_dt = torch.where(
            now <= ru, 0.0, torch.where(ru > now - dt, now - ru, dt))
        lam = self._lam(p, now)
        inf_m = live & (p["kind"] == KIND_INFER)
        alpha = torch.clamp_max(dt * recip32(300.0), 1.0)   # ~5 min
        s["rate_ewma"] = torch.where(
            inf_m, fma(alpha, lam - s["rate_ewma"], s["rate_ewma"]),
            s["rate_ewma"])
        s["demanded"] = torch.where(inf_m, fma(lam, dt, s["demanded"]),
                                    s["demanded"])
        # cold replicas serve only the tail of the tick past warm-up
        cold_frac = ((now - s["cold_until"])
                     / torch.clamp_min(dt, 1e-9)).clamp(0.0, 1.0)
        share = torch.where(heldf > 0,
                            s["cold_cnt"] / torch.clamp_min(heldf, 1.0),
                            0.0)
        cap_rps = heldf * p["cap_per_node"] \
            * fma(-share, 1.0 - cold_frac, 1.0)
        s["served"] = torch.where(
            inf_m, fma(torch.minimum(lam, cap_rps), dt, s["served"]),
            s["served"])
        s["cold_cnt"] = torch.where(inf_m & (now >= s["cold_until"]),
                                    0.0, s["cold_cnt"])
        wk = live & (p["kind"] != KIND_INFER)
        s["progress"] = torch.where(
            wk, fma(heldf * active_dt, PER_HOUR, s["progress"]),
            s["progress"])
        s["last_checkpoint"] = torch.where(
            wk & (now - s["last_checkpoint"]
                  >= p["checkpoint_interval_s"]),
            now, s["last_checkpoint"])
        s["done_at"] = torch.where(wk & (s["progress"] >= p["work"]),
                                   now, s["done_at"])
        s["last_t"] = torch.where(tick, now, s["last_t"])
        return s

    def desired_nodes(self, params, state, now):
        """Vectorized shared autoscaler (``Tenant.desired_nodes``)."""
        p, s = params, state
        now = self._now(now)
        done = torch.isfinite(s["done_at"])
        lam = self._lam(p, now)
        plan = torch.maximum(s["rate_ewma"], 0.7 * lam)
        want_inf = torch.minimum(
            p["max_nodes"], torch.ceil(plan / p["cap_per_node"]).to(I32))
        remaining = torch.clamp_min(p["work"] - s["progress"], 0.0)
        t_left = torch.clamp_min(p["arrival_s"] + p["deadline_s"] - now,
                                 1.0)
        need = remaining / (t_left * PER_HOUR)
        want_wk = torch.minimum(
            p["max_nodes"], torch.clamp_min(torch.ceil(need).to(I32), 0))
        want = torch.where(p["kind"] == KIND_INFER, want_inf, want_wk)
        return torch.where((now < p["arrival_s"]) | done, 0, want)

    # ------------------------------------------------ AppHooks, batched
    def _hooks(self, params, state, held):
        """Listing-1 inputs at ``last_t``: marginal utility, utility gap,
        $-value per gap, reconfiguration hours, gang size."""
        p, s = params, state
        heldf = held.to(F32)
        lam = self._lam(p, s["last_t"])
        # price off the planner's smoothed demand (audit A3)
        plan = torch.maximum(s["rate_ewma"], 0.7 * lam)
        is_inf = p["kind"] == KIND_INFER
        mu_inf = torch.where(plan > 0,
                             torch.minimum(p["cap_per_node"], plan)
                             / torch.clamp_min(plan, 1e-30), 0.0)
        mu_wk = torch.clamp_max(
            1.0 / torch.clamp_min(p["work"] - s["progress"], 1e-9), 1.0)
        mu = torch.where(is_inf, mu_inf, mu_wk)
        cap_rps = heldf * p["cap_per_node"]
        gap_inf = torch.where(
            plan > 0,
            torch.clamp_min(1.0 - cap_rps / torch.clamp_min(plan, 1e-30),
                            0.0),
            0.0)
        t_left = torch.clamp_min(
            p["arrival_s"] + p["deadline_s"] - s["last_t"], 1.0)
        need = torch.clamp_min(p["work"] - s["progress"], 0.0) \
            / (t_left * PER_HOUR)
        gap_wk = torch.clamp_min((need - heldf)
                                 / torch.clamp_min(need, 1e-9), 0.0)
        gap = torch.where(is_inf, gap_inf, gap_wk)
        urgency = fma(2.0, gap, 1.0)
        value = torch.where(is_inf, p["sla_value_per_h"] * _SLA_CREDITS,
                            p["value_per_gap"]) * urgency
        # stateless inference has no work at risk (audit A2)
        since_chkpt = torch.where(is_inf, 0.0,
                                  s["last_t"] - s["last_checkpoint"])
        reconf_h = (p["reconfig_s"] + since_chkpt) \
            * self.cfg.reconfig_estimate_mult * PER_HOUR
        # gang-stall scaling: a membership change restarts the whole
        # gang for train/batch, nothing extra for inference replicas
        gang = torch.where(is_inf, 0.0, heldf)
        return mu, gap, value, reconf_h, gang

    # the Listing-1 quote formulas, one definition each.  ``value * mu``
    # has two uses, which XLA's CPU backend leaves unfused; the
    # single-use switching-cost product is fused into the final add
    def _grow_price(self, mu, value, reconf_h, ref, gang):
        vm = value * mu
        burn = (gang + 1.0) * (vm + ref)
        return fma(-reconf_h, burn / self.cfg.horizon_h, vm)

    def _retention_limit(self, mu, value, reconf_h, rate, gang):
        vm = value * mu
        burn = (gang + 1.0) * (vm + torch.clamp_min(rate, 1e-6))
        return fma(reconf_h, burn / self.cfg.horizon_h, vm)

    def listing1(self, params, state, held, ref, rate):
        """Listing-1 quotes for every tenant: grow-bid price against
        ``ref`` and retention limit against ``rate``."""
        mu, _gap, value, reconf_h, gang = self._hooks(params, state, held)
        return (self._grow_price(mu, value, reconf_h, ref, gang),
                self._retention_limit(mu, value, reconf_h, rate, gang))

    @staticmethod
    def _rank_in_group(group, *tie_keys):
        """Rank of every element within its ``group`` under the order
        ``lexsort((*tie_keys, group))`` (tie_keys minor -> major), by
        stable sorts from the least significant key."""
        L = group.shape[0]
        dev = group.device
        perm = torch.arange(L, device=dev)
        for key in (*tie_keys, group):
            if key.is_floating_point():
                key = f32_order_key(key)
            perm = perm[torch.sort(key[perm], stable=True).indices]
        sg = group[perm].contiguous()
        first = torch.searchsorted(sg, sg, side="left", out_int32=True)
        pos = arange32(L, dev)
        return scatter_drop(torch.zeros(L, dtype=I32, device=dev), perm,
                            pos - first)

    # ------------------------------------------------------------ policy
    def policy(self, params, state, now, owner, rate_leaf, floors):
        """One epoch of the fleet's renegotiation policy: retention
        limits on kept leaves, surplus pruning under the 120 s
        hysteresis, and grow bids toward desired nodes, as engine-ready
        tensors.  Returns ``(limits, relinquish, sel, bids, state,
        info)``; ``sel`` is the per-leaf graceful-release mask."""
        cfg = self.cfg
        n, tree = cfg.n, self.tree
        dev = self.device
        p, s = params, dict(state)
        now = self._now(now)
        n_leaves = tree.n_leaves
        leafid = arange32(n_leaves, dev)
        owner_c = owner.clamp(0, n - 1)
        owned = (owner >= 0) & (owner < n)
        held = _count(n, owner_c, owned)
        want = self.desired_nodes(p, s, now)
        mu, gap, value, reconf_h, gang = self._hooks(p, s, held)

        # ---- surplus pruning (rate desc, leaf asc) under hysteresis
        extra = held - want
        eligible = (now - s["last_scale_down"] >= cfg.hysteresis_s) \
            & (extra > 0)
        rank = self._rank_in_group(torch.where(owned, owner, n),
                                   leafid, -rate_leaf)
        oc = owner_c.long()
        sel = owned & eligible[oc] & (rank < extra[oc])
        # relinquish ids: sel's leaves ascending, padded with -1
        sel_rank = torch.cumsum(i32(sel), 0, dtype=I32) - 1
        relinq = scatter_drop(
            torch.full((n_leaves,), -1, dtype=I32, device=dev),
            torch.where(sel, sel_rank, n_leaves), leafid)
        rel_cnt = _count(n, owner_c, sel)
        s["last_scale_down"] = torch.where(rel_cnt > 0, now,
                                           s["last_scale_down"])

        # ---- retention limits on kept leaves
        lim_leaf = self._retention_limit(
            mu[oc], value[oc], reconf_h[oc], rate_leaf, gang[oc])
        limits = torch.where(owned & ~sel, lim_leaf, float("nan"))

        # ---- grow bids at the type root, priced against the
        # cluster-min path floor
        floor_leaf = torch.zeros((n_leaves,), dtype=F32, device=dev)
        for d, st_d in enumerate(tree.strides):
            floor_leaf = torch.maximum(
                floor_leaf, floors[d][(leafid // st_d).long()])
        ref = torch.min(floor_leaf)
        price = self._grow_price(mu, value, reconf_h, ref, gang)
        # churn guard: no grow bids mid-reconfiguration
        can_bid = (want > held) & (now >= p["arrival_s"]) \
            & ~torch.isfinite(s["done_at"]) & (price > 0) \
            & (now > s["reconfig_until"])
        nb = torch.where(can_bid,
                         torch.clamp_max(want - held, cfg.per_tenant_bids),
                         0)
        offsets = torch.cumsum(nb, 0, dtype=I32)
        total = offsets[-1]
        j = arange32(cfg.b_max, dev)
        tid = torch.searchsorted(offsets, j, side="right", out_int32=True)
        valid = j < torch.clamp_max(total, cfg.b_max)
        tid_c = tid.clamp(0, n - 1)
        bid_price = torch.where(valid, price[tid_c.long()], 0.0).to(F32)
        bids = {
            "price": bid_price,
            "limit": bid_price.clone(),
            "level": torch.full((cfg.b_max,), tree.n_levels - 1,
                                dtype=I32, device=dev),
            "node": torch.zeros((cfg.b_max,), dtype=I32, device=dev),
            "tenant": torch.where(valid, tid_c, -1).to(I32),
        }
        info = {"bids": torch.clamp_max(total, cfg.b_max),
                "bids_clipped": torch.clamp_min(total - cfg.b_max, 0),
                "relinquished": sel.sum(dtype=I32)}
        return limits, relinq, sel, bids, s, info

    def apply_policy_log(self, state, now, owner, sel):
        """Replay ``policy``'s only state change (the hysteresis stamp)
        from a logged graceful-release mask."""
        n = self.cfg.n
        s = dict(state)
        now = self._now(now)
        rel_cnt = _count(n, owner.clamp(0, n - 1), sel)
        s["last_scale_down"] = torch.where(rel_cnt > 0, now,
                                           s["last_scale_down"])
        return s

    # -------------------------------------------------------- transfers
    def after_step(self, params, state, now, owner_before, owner_after,
                   sel):
        """Apply the engine's per-leaf ownership delta: reconfiguration
        windows for every touched tenant, and wasted work since the
        last checkpoint for involuntary revocations.  Returns the
        updated state and the post-transfer held counts."""
        cfg, p = self.cfg, params
        n = cfg.n
        s = dict(state)
        now = self._now(now)
        n_leaves = owner_before.shape[0]
        leafid = arange32(n_leaves, self.device)
        ob_c = owner_before.clamp(0, n - 1)
        oa_c = owner_after.clamp(0, n - 1)
        owned_b = (owner_before >= 0) & (owner_before < n)
        owned_a = (owner_after >= 0) & (owner_after < n)
        held_before = _count(n, ob_c, owned_b)
        held_after = _count(n, oa_c, owned_a)
        moved = owner_before != owner_after
        lost = moved & owned_b
        gain = moved & owned_a
        forced = lost & ~sel
        # wasted work: the per-ordinal throughput (h0 - k - 1) of the
        # object path's leaf-ascending revoke order
        k_rank = self._rank_in_group(torch.where(lost, ob_c, n), leafid)
        waste_s = torch.minimum(now - s["last_checkpoint"],
                                p["checkpoint_interval_s"])
        # every term is a small non-negative integer, so the int32 sum
        # equals the reference's float32 scatter-add in any order
        contrib = torch.where(forced, held_before[ob_c.long()] - k_rank
                              - 1, 0)
        lost_nodes_s = scatter_add_drop(n, ob_c, i32(contrib)).to(F32)
        lost_h = torch.clamp_min(waste_s, 0.0) * PER_HOUR
        wk = p["kind"] != KIND_INFER
        s["progress"] = torch.where(
            wk, torch.clamp_min(fma(-lost_h, lost_nodes_s, s["progress"]),
                                0.0),
            s["progress"])
        gain_cnt = _count(n, oa_c, gain)
        lost_cnt = _count(n, ob_c, lost)
        touched = (gain_cnt > 0) | (lost_cnt > 0)
        done = torch.isfinite(s["done_at"])
        is_inf = p["kind"] == KIND_INFER
        # restart absorption (audit A3)
        reconf_end = fma(p["reconfig_s"], p["overhead_mult"], now)
        s["reconfig_until"] = torch.where(
            touched & ~done & ~is_inf & (now > s["reconfig_until"]),
            reconf_end, s["reconfig_until"])
        # inference cold-start batch merge
        cold0 = torch.where(now >= s["cold_until"], 0.0, s["cold_cnt"])
        cold1 = cold0 + gain_cnt.to(F32)
        s["cold_cnt"] = torch.where(
            is_inf & touched,
            torch.minimum(cold1, held_after.to(F32)), s["cold_cnt"])
        s["cold_until"] = torch.where(is_inf & (gain_cnt > 0), reconf_end,
                                      s["cold_until"])
        return s, held_after

    # ---------------------------------------------- alone counterfactual
    def resize_to_desired(self, params, state, now, held):
        """Analytic 'alone' allocator: grant desired nodes at once,
        shrink under the same hysteresis; reconfiguration windows and
        cold starts still apply."""
        p, s = params, dict(state)
        now = self._now(now)
        want = torch.clamp_max(self.desired_nodes(p, s, now),
                               self.tree.n_leaves)
        can_shrink = now - s["last_scale_down"] >= self.cfg.hysteresis_s
        target = torch.where(want < held,
                             torch.where(can_shrink, want, held), want)
        done = torch.isfinite(s["done_at"])
        touched = (target != held) & ~done
        is_inf = p["kind"] == KIND_INFER
        reconf_end = fma(p["reconfig_s"], p["overhead_mult"], now)
        s["reconfig_until"] = torch.where(
            touched & ~is_inf & (now > s["reconfig_until"]),
            reconf_end, s["reconfig_until"])
        gain = torch.clamp_min(target - held, 0).to(F32)
        cold0 = torch.where(now >= s["cold_until"], 0.0, s["cold_cnt"])
        s["cold_cnt"] = torch.where(
            is_inf & touched,
            torch.minimum(cold0 + gain, target.to(F32)), s["cold_cnt"])
        s["cold_until"] = torch.where(is_inf & (gain > 0), reconf_end,
                                      s["cold_until"])
        s["last_scale_down"] = torch.where(target < held, now,
                                           s["last_scale_down"])
        return s, target

    # ----------------------------------------------------------- metrics
    def performance(self, params, state, now):
        """Vectorized ``Tenant.performance`` (paper §5.1)."""
        p, s = params, state
        now = self._now(now)
        perf_inf = torch.where(
            s["demanded"] > 0,
            s["served"] / torch.clamp_min(s["demanded"], 1e-30), 1.0)
        expected = p["work"] * torch.clamp_max(
            torch.clamp_min(now - p["arrival_s"], 1e-9)
            / torch.clamp_min(p["deadline_s"], 1e-9), 1.0)
        perf_wk = torch.where(
            torch.isfinite(s["done_at"]), 1.0,
            torch.where(expected > 0,
                        torch.clamp_max(
                            s["progress"]
                            / torch.clamp_min(expected, 1e-30), 1.0),
                        1.0))
        return torch.where(p["kind"] == KIND_INFER, perf_inf, perf_wk)
