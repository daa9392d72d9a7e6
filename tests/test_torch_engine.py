"""Parity of the port's ``BatchEngine`` (``repro_torch.market_torch``)
with the JAX reference ``repro.market_jax.engine.BatchEngine``.

The same random op traces (place, cancel, cancel_all, set_health, and
step with bids, floor updates, relinquishes and limit refreshes), made
from numpy seeds, run on both engines at K=1 and K=8 with every
volatility control on.  After every op the whole state must be equal,
key for key (bills included: the port adds each tenant's accruals in
leaf order, as the reference's CPU scatter does), and after every step
the port's state, converted to numpy, must pass the reference's
``schema.validate_state``.
Each step passes all four optional inputs (padding where unused), so
the reference compiles one step per engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.market import VolatilityControls as JControls
from repro.market_jax import schema
from repro.market_jax.engine import BatchEngine as JEngine
from repro.market_jax.engine import build_tree as jbuild_tree
from repro_torch.convert import to_numpy
from repro_torch.core.market import VolatilityControls
from repro_torch.device import seq_scatter_add
from repro_torch.market_torch.engine import BatchEngine, build_tree

N_LEAVES, CAP, N_TEN = 64, 256, 12
_CTRL = dict(max_bid_multiple=4.0, floor_fall_rate=0.5, min_holding_s=600.0)
torch.set_num_threads(1)     # small tensors; leave the cores to XLA
# module-level reference engines: jitted graphs compile once per K
_JENG = {k: JEngine(jbuild_tree(N_LEAVES), capacity=CAP, n_tenants=N_TEN,
                    k=k, controls=JControls(**_CTRL)) for k in (1, 8)}


def _np(state):
    return jax.tree_util.tree_map(np.asarray, state)


def _assert_same(jst, tst, where):
    a, b = _np(dict(jst)), to_numpy(dict(tst))
    assert set(a) == set(b), where
    for key in a:
        if key in ("floor", "floor_t"):
            for d, (x, y) in enumerate(zip(a[key], b[key])):
                np.testing.assert_array_equal(x, y,
                                              err_msg=f"{where} {key}[{d}]")
        else:
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"{where} {key}")
    return b


def _ops(rng, tree, n_ops, p=(0.3, 0.1, 0.05, 0.1, 0.45), cap=CAP):
    """A random op trace as numpy payloads (shared by both engines)."""
    t, ops = 0.0, []
    for _ in range(n_ops):
        kind = rng.choice(["place", "cancel", "cancel_all", "health",
                           "step"], p=list(p))
        if kind == "place":
            b = 16
            levels = rng.integers(0, tree.n_levels, b).astype(np.int32)
            nodes = np.array([rng.integers(0, tree.nodes_at(d))
                              for d in levels], np.int32)
            prices = rng.uniform(0.5, 9.0, b).astype(np.float32)
            prices[::4] = np.round(prices[::4])      # equal-price ties
            tenants = rng.integers(-1, N_TEN, b).astype(np.int32)
            limits = (prices * rng.uniform(1.0, 1.5, b)).astype(np.float32)
            ops.append(("place", (prices, levels, nodes, tenants, limits)))
        elif kind == "cancel":
            ops.append(("cancel",
                        rng.integers(0, cap, 8).astype(np.int32)))
        elif kind == "cancel_all":
            ops.append(("cancel_all", None))
        elif kind == "health":
            m = 3
            levels = rng.integers(0, tree.n_levels - 1, m).astype(np.int32)
            nodes = np.array([rng.integers(0, tree.nodes_at(d))
                              for d in levels], np.int32)
            values = rng.choice([-1, 0, 0, 1, 2], m).astype(np.int32)
            ops.append(("health", (levels, nodes, values)))
        else:
            t += float(rng.uniform(1.0, 900.0))
            b = 8
            levels = rng.integers(0, tree.n_levels, b).astype(np.int32)
            bids = {
                "price": rng.uniform(0.5, 9.0, b).astype(np.float32),
                "limit": rng.uniform(0.5, 14.0, b).astype(np.float32),
                "level": levels,
                "node": np.array([rng.integers(0, tree.nodes_at(d))
                                  for d in levels], np.int32),
                "tenant": (rng.integers(-1, N_TEN, b) if rng.random() < 0.7
                           else np.full(b, -1)).astype(np.int32),
            }
            floors = tuple(
                np.where(rng.random(tree.nodes_at(d)) < 0.2,
                         rng.uniform(0.0, 6.0, tree.nodes_at(d)),
                         -1.0).astype(np.float32)
                for d in range(tree.n_levels))
            relinq = rng.integers(-1, tree.n_leaves, 4).astype(np.int32)
            lim = rng.uniform(1.0, 20.0, tree.n_leaves)
            lim = np.where(rng.random(tree.n_leaves) < 0.8, np.nan, lim)
            ops.append(("step", (np.float32(t), bids, floors, relinq,
                                 lim.astype(np.float32))))
    return ops


def _apply(eng, state, op, payload, conv):
    if op == "place":
        return eng.place(state, *map(conv, payload))
    if op == "cancel":
        return eng.cancel(state, conv(payload))
    if op == "cancel_all":
        return eng.cancel_all(state)
    if op == "health":
        return eng.set_health(state, *map(conv, payload))
    t, bids, floors, relinq, lim = payload
    state, _, _ = eng.step(state, float(t),
                           {k: conv(v) for k, v in bids.items()},
                           tuple(conv(f) for f in floors), conv(relinq),
                           conv(lim))
    return state


@pytest.mark.parametrize("k,seed", [(1, 0), (8, 0)])
def test_engine_trace_matches_reference(k, seed):
    jeng = _JENG[k]
    teng = BatchEngine(build_tree(N_LEAVES), capacity=CAP,
                       n_tenants=N_TEN, k=k,
                       controls=VolatilityControls(**_CTRL), device="cpu")
    rng = np.random.default_rng(1000 * k + seed)
    jst, tst = jeng.init_state(), teng.init_state()
    _assert_same(jst, tst, "init")
    stepped = 0
    for i, (op, payload) in enumerate(_ops(rng, teng.tree, 48)):
        jst = _apply(jeng, jst, op, payload, jnp.asarray)
        tst = _apply(teng, tst, op, payload, torch.from_numpy)
        host = _assert_same(jst, tst, f"op {i} ({op})")
        if op == "step":
            # set_health leaves a down leaf's owner for the next step to
            # evict, so the full invariant set holds at step boundaries
            schema.validate_state(host, jeng, where=f"port op {i}")
            stepped += 1
    assert stepped > 0 and int(tst["waves"]) > 0


def test_engine_overflow_matches_reference():
    """A 32-slot table under a place-heavy trace: the ring allocator
    wraps, skips live orders and drops the overflow (``dropped``)."""
    cap = 32
    jeng = JEngine(jbuild_tree(N_LEAVES), capacity=cap, n_tenants=N_TEN,
                   k=4, controls=JControls(**_CTRL))
    teng = BatchEngine(build_tree(N_LEAVES), capacity=cap,
                       n_tenants=N_TEN, k=4,
                       controls=VolatilityControls(**_CTRL), device="cpu")
    rng = np.random.default_rng(77)
    jst, tst = jeng.init_state(), teng.init_state()
    for i, (op, payload) in enumerate(_ops(rng, teng.tree, 24,
                                           p=(0.6, 0.15, 0.0, 0.0, 0.25),
                                           cap=cap)):
        jst = _apply(jeng, jst, op, payload, jnp.asarray)
        tst = _apply(teng, tst, op, payload, torch.from_numpy)
        _assert_same(jst, tst, f"op {i} ({op})")
    assert int(tst["dropped"]) > 0


def test_seq_scatter_add_is_sequential():
    """Each target's adds happen one at a time in index order — what
    numpy's unbuffered ``add.at`` does in float32."""
    rng = np.random.default_rng(7)
    base = rng.uniform(0, 100, 20).astype(np.float32)
    idx = rng.integers(-2, 22, 500).astype(np.int32)
    src = rng.uniform(0, 1e3, 500).astype(np.float32)
    want = base.copy()
    ok = (idx >= 0) & (idx < 20)
    np.add.at(want, idx[ok], src[ok])
    got = seq_scatter_add(torch.from_numpy(base), torch.from_numpy(idx),
                          torch.from_numpy(src))
    np.testing.assert_array_equal(want, got.numpy())
