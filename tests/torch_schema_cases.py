"""Break cases for the engine state contract
(``repro_torch.market_torch.schema``): each case breaks one invariant
of a clean state (or, for the ``first_*`` cases, two, where the checker
must report the one earlier in the reference's program order) and names
the error it must raise.

Shared by ``tests/test_torch_schema.py`` (on the CPU, where the
reference's checker must raise the same message) and ``chip_smoke.py``
(on the card).  Imports torch and numpy only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch

NEG = -1e30


@dataclass(frozen=True)
class BreakCase:
    name: str
    kind: str        # "runtime": StateInvariantError; "static": AssertionError
    expect: str      # a part of the message the checker must raise
    apply: Callable  # (state copy, engine) -> None, edits the copy in place


def clean_state(eng, seed: int = 0) -> Dict[str, object]:
    """A state that passes every check and has what the cases need:
    owned leaves, floors at every level, live resting orders (two or
    more in one segment, the root's, and some at the leaves) and a
    clock past zero.  One step with bids, then a place."""
    tree, dev = eng.tree, eng.device
    rng = np.random.default_rng(seed)
    top = tree.n_levels - 1

    def t32(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
    floors = tuple(t32(np.where(rng.random(tree.nodes_at(d)) < 0.5,
                                rng.uniform(0.5, 2.0, tree.nodes_at(d)),
                                -1.0), torch.float32)
                   for d in range(tree.n_levels))
    b = 12
    bids = {"price": t32(rng.uniform(3.0, 9.0, b), torch.float32),
            "limit": t32(rng.uniform(9.0, 14.0, b), torch.float32),
            "level": t32(np.full(b, top), torch.int32),
            "node": t32(np.zeros(b), torch.int32),
            "tenant": t32(np.arange(b) % eng.n_tenants, torch.int32)}
    st, _, _ = eng.step(eng.init_state(), 30.0, bids, floors, None)
    # below every floor: these rest in the book
    m = 6
    st = eng.place(st, t32(np.full(m, 0.1) + 0.01 * np.arange(m),
                           torch.float32),
                   t32([top, top, top, 0, 0, 0], torch.int32),
                   t32([0, 0, 0, 1, 1, 2], torch.int32),
                   t32(np.arange(m) % eng.n_tenants, torch.int32),
                   t32(np.full(m, 5.0), torch.float32))
    return dict(st)


def copy_state(state) -> Dict[str, object]:
    out = {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
           for k, v in state.items()}
    return out


def _set(st, key, idx, value) -> None:
    x = st[key].clone()
    x[idx] = value
    st[key] = x


def _set_level(st, key, d, idx, value) -> None:
    levels = list(st[key])
    x = levels[d].clone()
    x[idx] = value
    levels[d] = x
    st[key] = tuple(levels)


def _scalar(st, key, value) -> None:
    st[key] = torch.full_like(st[key], value)


def _live_slots(st) -> np.ndarray:
    return np.nonzero(st["price"].cpu().numpy() > NEG / 2)[0]


def _slot(st) -> int:
    """A live slot of the bid table."""
    live = _live_slots(st)
    if live.size == 0:
        raise ValueError("the clean state holds no live order")
    return int(live[0])


def _dead_slot(st) -> int:
    price = st["price"].cpu().numpy()
    dead = np.nonzero(price <= NEG / 2)[0]
    if dead.size == 0:
        raise ValueError("the clean state has no free slot")
    return int(dead[0])


def _same_segment_pair(st):
    """Two live slots that sit next to each other, in this order, in one
    segment of the sorted view."""
    order = st["order"].cpu().numpy()
    sg = st["sorted_gseg"].cpu().numpy()
    live_pos = (st["price"].cpu().numpy() > NEG / 2)[order]
    pos = np.nonzero(live_pos)[0]
    for a, b in zip(pos[:-1], pos[1:]):
        if sg[a] == sg[b]:
            return int(order[a]), int(order[b])
    raise ValueError("no segment of the clean state holds two live orders")


def _t(st) -> float:
    return float(st["t"])


# ------------------------------------------------------------- runtime
def _hole_live(st, eng):
    _set(st, "tenant", _slot(st), -1)


def _hole_dead(st, eng):
    _set(st, "tenant", _dead_slot(st), 3)


def _price_inf(st, eng):
    _set(st, "price", _slot(st), float("inf"))


def _tenant_range(st, eng):
    _set(st, "tenant", _slot(st), eng.n_tenants)


def _blimit(st, eng):
    b = _slot(st)
    _set(st, "blimit", b, float(st["price"][b]) - 1.0)


def _level_range(st, eng):
    _set(st, "level", _slot(st), eng.tree.n_levels)


def _node_range(st, eng):
    b = _slot(st)
    _set(st, "node", b, eng.tree.nodes_at(int(st["level"][b])))


def _seq_overrun(st, eng):
    _set(st, "seq", _slot(st), int(st["next_seq"]) + 5)


def _cap_head(st, eng):
    _scalar(st, "head", eng.capacity)


def _order_dup(st, eng):
    _set(st, "order", 0, int(st["order"][1]))


def _sg_range(st, eng):
    _set(st, "sorted_gseg", -1, eng.n_seg_total + 1)


def _sg_decreasing(st, eng):
    prev = int(st["sorted_gseg"][-2])
    if prev <= 0:
        raise ValueError("the sorted view's last two keys are 0")
    _set(st, "sorted_gseg", -1, prev - 1)


def _seg_start(st, eng):
    _set(st, "seg_start", 0, int(st["seg_start"][0]) + 1)


def _stale(st, eng):
    """Re-scope a live order to another level: its segment no longer
    matches its sorted position's key."""
    b = _slot(st)
    _set(st, "level", b, (int(st["level"][b]) + 1) % eng.tree.n_levels)
    _set(st, "node", b, 0)


def _out_of_order(st, eng):
    first, second = _same_segment_pair(st)
    p = float(st["price"][first]) + 1.0
    _set(st, "price", second, p)
    _set(st, "blimit", second, max(p, float(st["blimit"][second])))


def _owner_range(st, eng):
    _set(st, "owner", 0, eng.n_tenants)


def _unowned_limit(st, eng):
    _set(st, "owner", 0, -1)
    _set(st, "limit", 0, 3.0)


def _acq_future(st, eng):
    _set(st, "acq_t", 0, _t(st) + 100.0)


def _down_owner(st, eng):
    _set(st, "owner", 0, 0)
    _set(st, "health", 0, 2)


def _floor(d, value):
    def f(st, eng):
        _set_level(st, "floor", d % eng.tree.n_levels, 0, value)
    return f


def _floor_t_future(d):
    def f(st, eng):
        _set_level(st, "floor_t", d % eng.tree.n_levels, 0, _t(st) + 100.0)
    return f


def _both(*fns):
    def f(st, eng):
        for fn in fns:
            fn(st, eng)
    return f


def _set_fn(key, idx, value):
    return lambda st, eng: _set(st, key, idx, value)


def _scalar_fn(key, value):
    return lambda st, eng: _scalar(st, key, value)


# -------------------------------------------------------------- static
def _drop(key):
    def f(st, eng):
        del st[key]
    return f


def _extra(st, eng):
    st["extra"] = torch.zeros(3, dtype=torch.float32, device=eng.device)


def _retype(key, dtype):
    def f(st, eng):
        st[key] = st[key].to(dtype)
    return f


def _bills_shape(st, eng):
    st["bills"] = torch.zeros(3, dtype=torch.float32, device=eng.device)


def _one_level_short(st, eng):
    st["floor"] = tuple(st["floor"])[:-1]


def _level_shape(st, eng):
    levels = list(st["floor_t"])
    levels[1] = torch.zeros(levels[1].shape[0] + 1, dtype=torch.float32,
                            device=eng.device)
    st["floor_t"] = tuple(levels)


def _level_dtype(st, eng):
    levels = list(st["floor"])
    levels[0] = levels[0].double()
    st["floor"] = tuple(levels)


R, S = "runtime", "static"
CASES: List[BreakCase] = [
    # one per check of the reference's _runtime_checks, in its order
    BreakCase("hole_live_slot", R, "hole convention", _hole_live),
    BreakCase("hole_dead_slot", R, "hole convention", _hole_dead),
    BreakCase("price_inf", R, "live entry with non-finite price",
              _price_inf),
    BreakCase("tenant_range", R, "tenant id out of range", _tenant_range),
    BreakCase("blimit_below_price", R, "blimit < price", _blimit),
    BreakCase("level_range", R, "scope level out of", _level_range),
    BreakCase("node_range", R, "node index out of range", _node_range),
    BreakCase("next_seq_negative", R, "next_seq negative",
              _scalar_fn("next_seq", -1)),
    BreakCase("seq_overrun", R, "live seq stamp outside", _seq_overrun),
    BreakCase("head_range", R, "ring cursor head", _cap_head),
    BreakCase("dropped_negative", R, "dropped count negative",
              _scalar_fn("dropped", -1)),
    BreakCase("waves_negative", R, "wave count negative",
              _scalar_fn("waves", -1)),
    BreakCase("resorts_negative", R, "resort count negative",
              _scalar_fn("resorts", -1)),
    BreakCase("clock_negative", R, "engine clock negative",
              _scalar_fn("t", -1.0)),
    BreakCase("order_not_permutation", R, "not a permutation", _order_dup),
    BreakCase("sorted_gseg_range", R, "sorted_gseg outside", _sg_range),
    BreakCase("sorted_gseg_decreasing", R, "not non-decreasing",
              _sg_decreasing),
    BreakCase("seg_start_mismatch", R, "seg_start inconsistent",
              _seg_start),
    BreakCase("view_stale", R, "sorted view stale", _stale),
    BreakCase("view_out_of_order", R, "sorted view out of order",
              _out_of_order),
    BreakCase("owner_range", R, "owner id outside", _owner_range),
    BreakCase("unowned_finite_limit", R, "finite retention limit",
              _unowned_limit),
    BreakCase("acq_t_future", R, "acquisition time in the future",
              _acq_future),
    BreakCase("health_range", R, "health outside",
              _set_fn("health", 0, 3)),
    BreakCase("owner_on_down_leaf", R, "owner on a down leaf", _down_owner),
    BreakCase("rate_negative", R, "charged rate", _set_fn("rate", 0, -1.0)),
    BreakCase("rate_nan", R, "charged rate",
              _set_fn("rate", 0, float("nan"))),
    BreakCase("bills_nan", R, "bill vector",
              _set_fn("bills", 0, float("nan"))),
    BreakCase("floor_negative_leaf_level", R, "floor non-finite",
              _floor(0, -1.0)),
    BreakCase("floor_inf_root_level", R, "floor non-finite",
              _floor(-1, float("inf"))),
    BreakCase("floor_t_future_leaf_level", R, "floor update time",
              _floor_t_future(0)),
    BreakCase("floor_t_future_root_level", R, "floor update time",
              _floor_t_future(-1)),
    # two breaks: the earlier check in program order is reported
    BreakCase("first_of_limit_and_health", R, "finite retention limit",
              _both(_set_fn("health", 1, 3), _unowned_limit)),
    BreakCase("first_of_floor_t0_and_floor1", R, "floor update time",
              _both(_floor(1, -1.0), _floor_t_future(0))),
    BreakCase("first_of_head_and_bills", R, "ring cursor head",
              _both(_set_fn("bills", 0, float("nan")), _cap_head)),
    BreakCase("first_of_permutation_and_range", R, "not a permutation",
              _both(_sg_range, _order_dup)),
    # the static contract
    BreakCase("missing_key", S, "missing key 'waves'", _drop("waves")),
    BreakCase("undeclared_key", S, "undeclared key 'extra'", _extra),
    BreakCase("shape_drift", S, "['bills']: shape (3,)", _bills_shape),
    BreakCase("dtype_drift_float", S, "['seq']: dtype float32, expected "
              "int32", _retype("seq", torch.float32)),
    BreakCase("dtype_drift_int64", S, "['head']: dtype int64, expected "
              "int32", _retype("head", torch.int64)),
    BreakCase("level_count", S, "['floor']: 4 levels, expected 5",
              _one_level_short),
    BreakCase("level_shape", S, "['floor_t[1]']: shape", _level_shape),
    BreakCase("level_dtype", S, "['floor[0]']: dtype float64", _level_dtype),
    BreakCase("several_static", S, "missing key 't'",
              _both(_drop("t"), _extra, _retype("rate", torch.float64))),
]


def broken(state, eng, case: BreakCase) -> Dict[str, object]:
    """A copy of ``state`` with ``case`` applied (``state`` untouched)."""
    st = copy_state(state)
    case.apply(st, eng)
    return st
