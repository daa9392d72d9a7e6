"""Declared state contract for the batch market engine, machine-checked
— the twin of ``repro.market_jax.schema`` on PyTorch tensors.

The engine's state dict (``BatchEngine.init_state``) is a contract that
``step``, ``place``, ``cancel_all``, the cascade, both versions of the
clearing pass, the bridge's host copy and the fleet all rely on: the
same keys, dtypes, shapes and semantic invariants as the reference.
This module states it and checks it at three costs:

* ``SCHEMA`` / ``LEVEL_SCHEMA`` — the declared key table: dtype, shape
  expression in the engine's dimensions, and the invariant in prose
  (docs/DESIGN.md §9).
* ``check_state(state, engine)`` — STATIC check (exact key set, level
  count, dtype, shape), with the reference's error strings.  It reads
  only ``.shape`` and ``.dtype``, so it runs the same on live tensors
  and on ``meta`` tensors (``expected_struct``) and never touches the
  device.
* ``validate_state(state, engine)`` — the static check, then every
  semantic invariant of the reference's ``_runtime_checks`` as a torch
  predicate on the state's own device: the predicates are stacked into
  one bool tensor and read to the host once, and the first failing one
  in the reference's program order raises :class:`StateInvariantError`
  with the reference's message (what ``checkify`` reports under
  ``jit``).  ``maybe_validate`` is the hook the epoch runner, the
  crash-safe runner and the bridge call after every step that
  publishes a state; it runs only under ``LAISSEZ_VALIDATE=1``.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.device import arange32, scatter_add_drop, take
from repro_torch.kernels.market_clear.ref import NEG

VALIDATE_ENV = "LAISSEZ_VALIDATE"

_DTYPES = {"f32": torch.float32, "i32": torch.int32}
EPS = np.float32(1e-5)          # the reference's eps, a float32 constant
INF = float("inf")

#: states the hook validated in this process (``maybe_validate`` with
#: ``LAISSEZ_VALIDATE`` set); a run's count equals its publishes and
#: steps
VALIDATED = 0


@dataclass(frozen=True)
class KeySpec:
    """One state key: dtype tag, shape expression (evaluated over the
    engine dims ``n_leaves/capacity/n_levels/n_seg_total/n_tenants``;
    ``()`` = scalar) and the semantic invariant in prose."""
    dtype: str
    shape: Tuple[str, ...]
    invariant: str


# ---------------------------------------------------------------------------
# the declared contract — ONE row per state key (docs/DESIGN.md §9)
# ---------------------------------------------------------------------------
SCHEMA: Dict[str, KeySpec] = {
    # ---- bid table (ring buffer of OCO scoped orders) ----
    "price": KeySpec("f32", ("capacity",),
                     "bid price; NEG sentinel when dead; finite when "
                     "live; live == (price > NEG/2) == (tenant >= 0)"),
    "blimit": KeySpec("f32", ("capacity",),
                      "retention limit the winner inherits; "
                      ">= price for live entries"),
    "level": KeySpec("i32", ("capacity",),
                     "scope level; in [0, n_levels) for live entries"),
    "node": KeySpec("i32", ("capacity",),
                    "scope node index; in [0, nodes_at(level)) for "
                    "live entries"),
    "tenant": KeySpec("i32", ("capacity",),
                      "-1 dead hole, else dense id < n_tenants (the "
                      "-1 hole convention: tenant < 0 iff price <= "
                      "NEG/2)"),
    "seq": KeySpec("i32", ("capacity",),
                   "monotone arrival stamp; 0 <= seq < next_seq for "
                   "live entries (equal-price ties clear seq asc)"),
    "next_seq": KeySpec("i32", (),
                        "monotone arrival counter, >= every live seq"),
    "head": KeySpec("i32", (),
                    "ring-buffer cursor, in [0, capacity)"),
    "dropped": KeySpec("i32", (),
                       "cumulative overflow drop count, >= 0"),
    # ---- sorted book view (engine.py module docstring) ----
    "order": KeySpec("i32", ("capacity",),
                     "slot permutation of arange(capacity): the "
                     "segment-sorted view, key (segment asc, price "
                     "desc, seq asc)"),
    "sorted_gseg": KeySpec("i32", ("capacity",),
                           "non-decreasing segment key per sorted "
                           "position, in [0, n_seg_total]; live slots "
                           "still sit at their sort-time position "
                           "(kills never move entries)"),
    "seg_start": KeySpec("i32", ("n_seg_total + 1",),
                         "per-segment start offsets == searchsorted("
                         "sorted_gseg, arange(n_seg_total + 1))"),
    # ---- per-leaf ownership ----
    "owner": KeySpec("i32", ("n_leaves",),
                     "owning tenant id, -1 = operator/idle; in "
                     "[-1, n_tenants)"),
    "limit": KeySpec("f32", ("n_leaves",),
                     "owner's retention limit; +inf where unowned"),
    "acq_t": KeySpec("f32", ("n_leaves",),
                     "acquisition time of the current owner, <= t"),
    "rate": KeySpec("f32", ("n_leaves",),
                    "charged rate cached from the last clearing pass; "
                    "finite, >= 0"),
    "health": KeySpec("i32", ("n_leaves",),
                      "failure-domain health: 0 up, 1 draining (no new "
                      "owners, retention honored), 2 down (excluded "
                      "from slates, owner force-evicted by step); no "
                      "owner on a down leaf post-step"),
    # ---- billing / clock / instrumentation ----
    "bills": KeySpec("f32", ("n_tenants",),
                     "cumulative per-tenant bill = integral rate dt; "
                     "finite, >= 0"),
    "t": KeySpec("f32", (), "engine clock, >= 0, monotone across steps"),
    "waves": KeySpec("i32", (),
                     "cumulative cascade wave count, >= 0"),
    "resorts": KeySpec("i32", (),
                       "cumulative FULL lexsort count (incremental "
                       "view merges don't count), >= 0"),
}

# per-level keys: lists (tuples once stepped) of n_levels tensors, level
# d shaped (nodes_at(d),)
LEVEL_SCHEMA: Dict[str, KeySpec] = {
    "floor": KeySpec("f32", ("nodes_at(d)",),
                     "operator floor price per node; finite, >= 0"),
    "floor_t": KeySpec("f32", ("nodes_at(d)",),
                       "last floor-update time per node (bounds "
                       "floor_fall_rate drops), <= t"),
}

# the bid-table columns place() scatters into; any *live* write to one
# of these obligates sorted-view maintenance
BOOK_COLUMNS = ("price", "blimit", "level", "node", "tenant", "seq")

# the fused-epoch stat accumulators (sim/epoch.py threads these through
# the epoch; sim/recovery.py re-accumulates them on replay)
STAT_KEYS = ("orders", "transfers", "explicit_relinquish",
             "implicit_relinquish", "bids_clipped", "revoked_by_fault")

# the vectorized fleet's struct-of-arrays state (sim/fleet.py
# init_state), declared beside the engine's keys
FLEET_STATE_KEYS = ("progress", "served", "demanded", "rate_ewma",
                    "reconfig_until", "last_checkpoint", "last_t",
                    "last_scale_down", "done_at", "cold_cnt",
                    "cold_until")


# ---------------------------------------------------------------------
# Declared per-function effects: which state keys each engine / fleet /
# epoch entry point of the port may READ and WRITE, the reference's
# sets key for key under the port's qualnames.  ``trace_effects`` below
# checks observed writes against them at runtime.
# ---------------------------------------------------------------------
EFFECTS: Dict[str, Dict[str, tuple]] = {
    "repro_torch.market_torch.engine.BatchEngine.step": {
        "reads": ("acq_t", "bills", "blimit", "dropped", "floor",
                  "floor_t", "head", "health", "level", "limit",
                  "next_seq", "node", "order", "owner", "price", "rate",
                  "resorts", "seg_start", "seq", "sorted_gseg", "t",
                  "tenant", "waves"),
        "writes": ("acq_t", "bills", "blimit", "dropped", "floor",
                   "floor_t", "head", "level", "limit", "next_seq",
                   "node", "order", "owner", "price", "rate", "resorts",
                   "seg_start", "seq", "sorted_gseg", "t", "tenant",
                   "waves"),
    },
    "repro_torch.market_torch.engine.BatchEngine.place": {
        "reads": ("blimit", "dropped", "head", "level", "next_seq",
                  "node", "order", "price", "resorts", "seg_start",
                  "seq", "sorted_gseg", "tenant"),
        "writes": ("blimit", "dropped", "head", "level", "next_seq",
                   "node", "order", "price", "resorts", "seg_start",
                   "seq", "sorted_gseg", "tenant"),
    },
    "repro_torch.market_torch.engine.BatchEngine.cancel": {
        "reads": ("price", "tenant"),
        "writes": ("price", "tenant"),
    },
    "repro_torch.market_torch.engine.BatchEngine.cancel_all": {
        "reads": ("price", "seg_start", "tenant"),
        "writes": ("order", "price", "seg_start", "sorted_gseg",
                   "tenant"),
    },
    "repro_torch.market_torch.engine.BatchEngine.set_health": {
        "reads": ("health",),
        "writes": ("health",),
    },
    "repro_torch.market_torch.engine.BatchEngine._cascade": {
        "reads": ("acq_t", "blimit", "floor", "health", "limit",
                  "order", "owner", "price", "seg_start", "seq",
                  "sorted_gseg", "tenant", "waves"),
        "writes": ("acq_t", "limit", "owner", "price", "rate", "tenant",
                   "waves"),
    },
    "repro_torch.market_torch.bridge.BatchMarket.set_retention_limit": {
        "reads": ("acq_t", "bills", "blimit", "dropped", "floor",
                  "floor_t", "head", "health", "level", "limit",
                  "next_seq", "node", "order", "owner", "price", "rate",
                  "resorts", "seg_start", "seq", "sorted_gseg", "t",
                  "tenant", "waves"),
        "writes": ("acq_t", "bills", "blimit", "dropped", "floor",
                   "floor_t", "head", "level", "limit", "next_seq",
                   "node", "order", "owner", "price", "rate", "resorts",
                   "seg_start", "seq", "sorted_gseg", "t", "tenant",
                   "waves"),
    },
    "repro_torch.sim.epoch.EpochRunner.epoch": {
        "reads": ("acq_t", "bids_clipped", "bills", "blimit",
                  "cold_cnt", "cold_until", "demanded", "done_at",
                  "dropped", "explicit_relinquish", "floor", "floor_t",
                  "head", "health", "implicit_relinquish",
                  "last_checkpoint", "last_scale_down", "last_t",
                  "level", "limit", "next_seq", "node", "order",
                  "orders", "owner", "price", "progress", "rate",
                  "rate_ewma", "reconfig_until", "resorts",
                  "revoked_by_fault", "seg_start", "seq", "served",
                  "sorted_gseg", "t", "tenant", "transfers", "waves"),
        "writes": ("acq_t", "bids_clipped", "bills", "blimit",
                   "cold_cnt", "cold_until", "demanded", "done_at",
                   "dropped", "explicit_relinquish", "floor", "floor_t",
                   "head", "implicit_relinquish", "last_checkpoint",
                   "last_scale_down", "last_t", "level", "limit",
                   "next_seq", "node", "order", "orders", "owner",
                   "price", "progress", "rate", "rate_ewma",
                   "reconfig_until", "resorts", "revoked_by_fault",
                   "seg_start", "seq", "served", "sorted_gseg", "t",
                   "tenant", "transfers", "waves"),
    },
    "repro_torch.sim.fleet.Fleet.policy": {
        "reads": ("done_at", "last_checkpoint", "last_scale_down",
                  "last_t", "progress", "rate_ewma", "reconfig_until"),
        "writes": ("last_scale_down",),
    },
    "repro_torch.sim.fleet.Fleet.after_step": {
        "reads": ("cold_cnt", "cold_until", "done_at",
                  "last_checkpoint", "progress", "reconfig_until"),
        "writes": ("cold_cnt", "cold_until", "progress",
                   "reconfig_until"),
    },
    "repro_torch.sim.fleet.Fleet.advance": {
        "reads": ("cold_cnt", "cold_until", "demanded", "done_at",
                  "last_checkpoint", "last_t", "progress", "rate_ewma",
                  "reconfig_until", "served"),
        "writes": ("cold_cnt", "demanded", "done_at", "last_checkpoint",
                   "last_t", "progress", "rate_ewma", "served"),
    },
    "repro_torch.kernels.market_clear.ops.clear": {
        "reads": ("floor", "health", "limit", "order", "owner",
                  "price", "seg_start", "seq", "sorted_gseg", "tenant"),
        "writes": (),
    },
}


class StateInvariantError(ValueError):
    """A semantic invariant of the state contract failed.  ``str`` is
    the reference's ``checkify`` error text for the same check; the
    bare message is ``check``."""

    def __init__(self, check: str) -> None:
        super().__init__(f"{check} (`check` failed)")
        self.check = check


def dims_of(engine) -> Dict[str, int]:
    """The dimension bindings the shape expressions are evaluated in."""
    return {
        "n_leaves": engine.tree.n_leaves,
        "capacity": engine.capacity,
        "n_levels": engine.tree.n_levels,
        "n_seg_total": engine.n_seg_total,
        "n_tenants": engine.n_tenants,
    }


def _eval_shape(expr_tuple: Tuple[str, ...], dims: Dict[str, int]
                ) -> Tuple[int, ...]:
    return tuple(int(eval(e, {"__builtins__": {}}, dims))  # noqa: S307
                 for e in expr_tuple)


def expected_struct(engine) -> Dict[str, object]:
    """The contract as ``meta`` tensors (floors as tuples of per-level
    tensors) — shapes and dtypes with no storage, comparable key by key
    with any state."""
    dims = dims_of(engine)
    out: Dict[str, object] = {}
    for key, spec in SCHEMA.items():
        out[key] = torch.empty(_eval_shape(spec.shape, dims),
                               dtype=_DTYPES[spec.dtype], device="meta")
    for key, spec in LEVEL_SCHEMA.items():
        out[key] = tuple(
            torch.empty((engine.tree.nodes_at(d),),
                        dtype=_DTYPES[spec.dtype], device="meta")
            for d in range(engine.tree.n_levels))
    return out


def _dtype_name(dtype) -> str:
    """numpy's name of a torch dtype (``torch.int64`` -> ``int64``), as
    the reference prints the dtype of the arrays it checks."""
    return str(dtype).replace("torch.", "")


def check_state(state, engine, where: str = "state") -> List[str]:
    """STATIC contract check: exact key set, dtype and shape per key.

    Reads only ``.shape`` / ``.dtype``, so live and ``meta`` tensors
    check alike.  Returns a list of violation strings (empty = clean),
    worded as the reference's."""
    errors: List[str] = []
    want = expected_struct(engine)
    got_keys, want_keys = set(state), set(want)
    for k in sorted(want_keys - got_keys):
        errors.append(f"{where}: missing key {k!r}")
    for k in sorted(got_keys - want_keys):
        errors.append(f"{where}: undeclared key {k!r} (add it to "
                      f"market_jax/schema.py SCHEMA)")
    for k in sorted(got_keys & want_keys):
        exp, got = want[k], state[k]
        if k in LEVEL_SCHEMA:
            if len(got) != len(exp):
                errors.append(f"{where}[{k!r}]: {len(got)} levels, "
                              f"expected {len(exp)}")
                continue
            pairs = [(f"{k}[{d}]", e, g)
                     for d, (e, g) in enumerate(zip(exp, got))]
        else:
            pairs = [(k, exp, got)]
        for name, e, g in pairs:
            if tuple(g.shape) != tuple(e.shape):
                errors.append(f"{where}[{name!r}]: shape {tuple(g.shape)}"
                              f", expected {tuple(e.shape)}")
            if g.dtype != e.dtype:
                errors.append(f"{where}[{name!r}]: dtype "
                              f"{_dtype_name(g.dtype)}, expected "
                              f"{_dtype_name(e.dtype)}")
    return errors


# ---------------------------------------------------------------------------
# runtime semantic invariants
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=32)
def _consts(engine, device: torch.device):
    """Per-level node counts, segment offsets and ``EPS`` on ``device``,
    copied there once per engine."""
    tree = engine.tree
    nd = torch.tensor([tree.nodes_at(d) for d in range(tree.n_levels)],
                      dtype=torch.int32, device=device)
    off = torch.tensor(engine.level_off, dtype=torch.int32, device=device)
    eps = torch.tensor(EPS, dtype=torch.float32, device=device)
    return nd, off, eps


def _finite_at_least(x: torch.Tensor, lo) -> torch.Tensor:
    """``isfinite(x) & (x >= lo)`` in two comparisons: NaN fails both,
    -inf the first and +inf the second."""
    return (x >= lo) & (x < INF)


def _runtime_checks(engine, state) -> List[Tuple[str, torch.Tensor]]:
    """Every semantic invariant as ``(message, 0-d bool tensor)``, in the
    reference's program order; nothing is read to the host."""
    tree = engine.tree
    cap = engine.capacity
    n_seg = engine.n_seg_total
    price, tenant = state["price"], state["tenant"]
    dev = price.device
    nd, off, eps = _consts(engine, dev)
    checks: List[Tuple[str, torch.Tensor]] = []

    def check(ok, msg):
        checks.append((msg, torch.all(ok)))

    live = price > NEG / 2
    # ---- -1 hole conventions on the bid table ----
    check(live == (tenant >= 0),
          "hole convention broken: (price > NEG/2) and "
          "(tenant >= 0) disagree on some slot")
    # a live price is above NEG/2, so finite means below +inf
    check(~live | (price < INF), "live entry with non-finite price")
    check(tenant < engine.n_tenants,
          "tenant id out of range (>= n_tenants)")
    check(~live | (state["blimit"] >= price - eps),
          "live entry with blimit < price (place() stamps "
          "blimit = max(price, limit))")
    level, node = state["level"], state["node"]
    lvl_ok = (level >= 0) & (level < tree.n_levels)
    check(~live | lvl_ok,
          "live entry with scope level out of [0, n_levels)")
    lvl_c = level.clamp(0, tree.n_levels - 1).long()
    nd_l = nd[lvl_c]
    node_ok = (node >= 0) & (node < nd_l)
    check(~live | node_ok,
          "live entry with node index out of range for its level")
    # ---- seq monotonicity ----
    seq, next_seq = state["seq"], state["next_seq"]
    check(next_seq >= 0, "next_seq negative")
    check(~live | ((seq >= 0) & (seq < next_seq)),
          "live seq stamp outside [0, next_seq)")
    # ---- ring cursor / counters ----
    check((state["head"] >= 0) & (state["head"] < cap),
          "ring cursor head out of [0, capacity)")
    check(state["dropped"] >= 0, "dropped count negative")
    check(state["waves"] >= 0, "wave count negative")
    check(state["resorts"] >= 0, "resort count negative")
    t = state["t"]
    check(t >= 0, "engine clock negative")
    # ---- sorted book view validity ----
    order, sg = state["order"], state["sorted_gseg"]
    # the reference's .at[order].add(1, mode="drop"): a negative index
    # wraps once, then out-of-range indices drop
    o = order.long()
    counts = scatter_add_drop(cap, torch.where(o < 0, o + cap, o),
                              torch.ones_like(order))
    check(counts == 1,
          "order is not a permutation of arange(capacity)")
    check((sg >= 0) & (sg <= n_seg),
          "sorted_gseg outside [0, n_seg_total]")
    check(sg[1:] >= sg[:-1], "sorted_gseg not non-decreasing")
    want_ss = torch.searchsorted(sg.contiguous(), arange32(n_seg + 1, dev),
                                 side="left", out_int32=True)
    check(state["seg_start"] == want_ss,
          "seg_start inconsistent with sorted_gseg "
          "(searchsorted boundary mismatch)")
    # live slots must still sit inside their recorded segment (kills
    # only — mutations between sorts never move or re-scope an entry)
    node_c = torch.minimum(node.clamp_min(0), nd_l - 1)
    gseg_now = torch.where(live, off[lvl_c] + node_c, n_seg)
    live_pos = take(live, order)
    check(~live_pos | (take(gseg_now, order) == sg),
          "sorted view stale: a live slot's current segment "
          "differs from its sort-time segment key")
    # within a segment, live positions must run (price desc, seq asc):
    # each live position against the PREVIOUS live position (dead holes
    # in between skipped by a running max)
    pos = arange32(cap, dev)
    last_live = torch.cummax(torch.where(live_pos, pos, -1), 0).values
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev),
                      last_live[:-1]])
    prev_c = prev.clamp(0, cap - 1).long()
    cmp = live_pos & (prev >= 0) & (sg[prev_c] == sg)
    p_pos, q_pos = take(price, order), take(seq, order)
    p_prev, q_prev = p_pos[prev_c], q_pos[prev_c]
    in_order = (p_prev > p_pos) | ((p_prev == p_pos) & (q_prev < q_pos))
    check(~cmp | in_order,
          "sorted view out of order: a segment's live entries "
          "are not (price desc, seq asc)")
    # ---- per-leaf ownership ----
    owner = state["owner"]
    check((owner >= -1) & (owner < engine.n_tenants),
          "owner id outside [-1, n_tenants)")
    check((owner >= 0) | torch.isinf(state["limit"]),
          "unowned leaf with a finite retention limit "
          "(reclaims must reset limit to +inf)")
    t_eps = t + eps
    check(state["acq_t"] <= t_eps, "acquisition time in the future")
    health = state["health"]
    check((health >= 0) & (health <= 2),
          "health outside the up/draining/down lattice [0, 2]")
    check((health != 2) | (owner < 0),
          "owner on a down leaf (step must force-evict before "
          "any owner can persist on health == down)")
    rate = state["rate"]
    check(_finite_at_least(rate, 0),
          "charged rate non-finite or negative")
    # ---- billing ----
    bills = state["bills"]
    check(_finite_at_least(bills, -eps),
          "bill vector non-finite or negative")
    # ---- operator floors ----
    for d in range(tree.n_levels):
        f, ft = state["floor"][d], state["floor_t"][d]
        check(_finite_at_least(f, 0),
              "floor non-finite or negative at some level")
        check(ft <= t_eps, "floor update time in the future")
    return checks


def failed_checks(state, engine) -> List[str]:
    """The message of every runtime invariant that fails, in program
    order (one host read); assumes ``check_state`` passed."""
    checks = _runtime_checks(engine, state)
    ok = torch.stack([c for _, c in checks]).tolist()
    return [msg for (msg, _), good in zip(checks, ok) if not good]


def validate_state(state, engine, where: str = "state") -> None:
    """Full contract check on a live state: static (keys, dtypes,
    shapes), then the semantic invariants on the state's device.
    Raises ``AssertionError`` (static, the reference's joined list) or
    :class:`StateInvariantError` (the first failing invariant)."""
    errors = check_state(state, engine, where=where)
    if errors:
        raise AssertionError("state schema violation:\n  "
                             + "\n  ".join(errors))
    failed = failed_checks(state, engine)
    if failed:
        raise StateInvariantError(failed[0])


def maybe_validate(state, engine, where: str = "state") -> None:
    """Env-gated hook (``LAISSEZ_VALIDATE=1``) after every step that
    publishes a state.  Unset, it is one environment lookup: no tensor
    op and no host read."""
    if os.environ.get(VALIDATE_ENV, "0") not in ("", "0"):
        global VALIDATED
        VALIDATED += 1
        validate_state(state, engine, where=where)


def _flat_state_items(state):
    """(name, value) pairs with the per-level lists flattened: ``floor``
    becomes ``floor[0]``, ``floor[1]``, ... so buffers diff
    positionally."""
    for k, v in state.items():
        if k in LEVEL_SCHEMA:
            for d, arr in enumerate(v):
                yield f"{k}[{d}]", arr
        else:
            yield k, v


def _snapshot(state) -> Dict[str, torch.Tensor]:
    """A copy of every buffer: the traced function may write a buffer in
    place, and a CUDA tensor is only a handle."""
    return {k: torch.as_tensor(v).clone() for k, v in
            _flat_state_items(state)}


def _written(before: Dict[str, torch.Tensor], state) -> set:
    """The state keys whose buffers differ from ``before``: a new buffer
    or a new shape on the host, the values in one stacked comparison on
    the buffers' device and one host read."""
    observed, pairs = set(), []
    for k, v in _flat_state_items(state):
        base = k.split("[", 1)[0]
        old, new = before.get(k), torch.as_tensor(v)
        if old is None or old.shape != new.shape:
            observed.add(base)
        else:
            pairs.append((base, old, new))
    if pairs:
        dev = pairs[0][2].device
        differ = torch.stack([(old.to(new.device) != new).any().to(dev)
                              for _, old, new in pairs]).tolist()
        observed.update(base for (base, _, _), d in zip(pairs, differ) if d)
    return observed


def trace_effects(fn, state, *args, qualname: str, engine=None,
                  where: str = "call", record=None, **kwargs):
    """Runtime twin of the reference's static effect checker: run
    ``fn(state, *args, **kwargs)``, diff every state buffer before (a
    copy) against after, and assert the observed write-set is within the
    write-set declared for ``qualname`` in ``EFFECTS``, with the
    reference's message.  Returns ``fn``'s result unchanged (a function
    returning a tuple is diffed on element 0).  ``record``, a list,
    gets ``(qualname, sorted observed keys)``.

    When ``engine`` is given and the call touched the bid book or its
    sorted view, the full ``validate_state`` pass runs on the result (a
    live book write that skips view maintenance trips the sorted-view
    checks there even though its write-set looks declared)."""
    declared = set(EFFECTS[qualname]["writes"])
    before = _snapshot(state)
    out = fn(state, *args, **kwargs)
    new_state = out if isinstance(out, dict) else out[0]
    observed = _written(before, new_state)
    if record is not None:
        record.append((qualname, sorted(observed)))
    undeclared = observed - declared
    if undeclared:
        raise AssertionError(
            f"effect trace ({where}): {qualname} wrote undeclared "
            f"state key(s) {sorted(undeclared)} — fix the function or "
            "update schema.EFFECTS")
    book_or_view = set(BOOK_COLUMNS) | {"order", "sorted_gseg",
                                        "seg_start"}
    if engine is not None and observed & book_or_view:
        validate_state(new_state, engine,
                       where=f"{where} (trace_effects)")
    return out


def trace_epoch(runner, params, eng_state, fleet_state, stats, t,
                where: str = "epoch", record=None):
    """``runner.epoch`` (an ``EpochRunner``) under ``trace_effects`` for
    ``EpochRunner.epoch``, its engine, fleet and stats trees taken as one
    state (their keys are disjoint), and the engine step inside it under
    ``trace_effects`` for ``BatchEngine.step`` with the runner's engine.
    Returns the epoch's ``(eng_state, fleet_state, stats)``."""
    eng = runner.eng
    names = (tuple(eng_state), tuple(fleet_state), tuple(stats))
    step = eng.step

    def traced_step(state, *args, **kwargs):
        return trace_effects(
            step, state, *args,
            qualname="repro_torch.market_torch.engine.BatchEngine.step",
            engine=eng, where=where, record=record, **kwargs)

    def epoch(state):
        parts = [{k: state[k] for k in ks} for ks in names]
        e, f, s = runner.epoch(params, *parts, t)
        return {**e, **f, **s}
    eng.step = traced_step
    try:
        out = trace_effects(epoch, {**eng_state, **fleet_state, **stats},
                            qualname="repro_torch.sim.epoch.EpochRunner.epoch",
                            where=where, record=record)
    finally:
        del eng.step
    return tuple({k: out[k] for k in ks} for ks in names)
