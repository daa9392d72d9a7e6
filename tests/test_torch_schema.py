"""Parity of the port's state checker (``repro_torch.market_torch.schema``)
with the reference's ``repro.market_jax.schema`` on the CPU.

Both checkers pass every state of random op traces on the port's engine.
Each case of ``tests/torch_schema_cases.py`` breaks one invariant (or
two, where the earlier one in program order must be reported) of a clean
state: both checkers must raise, and the port's message must equal the
reference's (its first failing ``checkify`` check, or its static error
list).  The env-gated hook runs only under ``LAISSEZ_VALIDATE``, and the
four hook sites (the epoch runner's and the crash-safe runner's publish,
the facade's step and ``step_arrays``) fire once per publish or step.
"""
import gc

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.market_jax import schema as J
from repro.market_jax.engine import BatchEngine as JEngine
from repro.market_jax.engine import build_tree as jbuild_tree
from repro_torch.convert import to_numpy
from repro_torch.core.market import Market
from repro_torch.core.topology import build_cluster
from repro_torch.market_torch import schema as T
from repro_torch.market_torch.bridge import BatchMarket
from repro_torch.market_torch.engine import BatchEngine, build_tree
from repro_torch.sim import recovery as TR
from repro_torch.sim import simulator as TS
from repro_torch.sim.epoch import EpochRunner
from repro_torch.sim.traces import apply_event, market_trace

import torch_schema_cases as C

N_LEAVES, CAP, N_TEN, K = 64, 256, 12, 4
torch.set_num_threads(1)     # small tensors; leave the cores to XLA
# one engine per side: the reference's jitted checker is cached per engine
_TENG = BatchEngine(build_tree(N_LEAVES), capacity=CAP, n_tenants=N_TEN,
                    k=K, device="cpu")
_JENG = JEngine(jbuild_tree(N_LEAVES), capacity=CAP, n_tenants=N_TEN, k=K)
_CLEAN = C.clean_state(_TENG)
# tests/test_torch_recovery.py's 64-leaf fleet
FCFG = dict(regime="heavy", n_leaves=64, n_training=3, n_inference=3,
            n_batch=2, duration_s=300.0, tick_s=60.0, seed=3, k=4, b_max=64,
            per_tenant_bids=4, alone="none")


@pytest.fixture(autouse=True)
def _release_jax_programs():
    """Drop each test's compiled JAX programs when it ends (see
    ``tests/test_torch_fleet.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


def _port_error(state, where="state"):
    try:
        T.validate_state(state, _TENG, where=where)
    except (AssertionError, T.StateInvariantError) as e:
        return e
    return None


def _ref_error(state, where="state"):
    try:
        J.validate_state(to_numpy(state), _JENG, where=where)
    except (AssertionError, ValueError) as e:      # JaxRuntimeError
        return e
    return None


# ------------------------------------------------------------ the contract
def test_contract_tables_match_reference():
    assert T.VALIDATE_ENV == J.VALIDATE_ENV
    assert T.SCHEMA.keys() == J.SCHEMA.keys()
    for k, spec in T.SCHEMA.items():
        assert (spec.dtype, spec.shape, spec.invariant) == \
            (J.SCHEMA[k].dtype, J.SCHEMA[k].shape, J.SCHEMA[k].invariant)
    for k, spec in T.LEVEL_SCHEMA.items():
        assert spec == T.KeySpec(J.LEVEL_SCHEMA[k].dtype,
                                 J.LEVEL_SCHEMA[k].shape,
                                 J.LEVEL_SCHEMA[k].invariant)
    assert T.LEVEL_SCHEMA.keys() == J.LEVEL_SCHEMA.keys()
    assert (T.BOOK_COLUMNS, T.STAT_KEYS, T.FLEET_STATE_KEYS) == \
        (J.BOOK_COLUMNS, J.STAT_KEYS, J.FLEET_STATE_KEYS)
    assert T.dims_of(_TENG) == J.dims_of(_JENG)


def test_expected_struct_is_meta_and_matches_reference():
    got, want = T.expected_struct(_TENG), J.expected_struct(_JENG)
    assert got.keys() == want.keys()
    for k in got:
        pairs = zip(got[k], want[k]) if k in T.LEVEL_SCHEMA \
            else [(got[k], want[k])]
        for g, w in pairs:
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype) == f"torch.{np.dtype(w.dtype).name}"
    assert T.check_state(got, _TENG) == []


def test_check_state_reads_no_storage():
    """The static check reads only shapes and dtypes: ``meta`` copies of
    every static case give the live state's errors."""
    def meta(x):
        if isinstance(x, tuple):
            return tuple(meta(v) for v in x)
        return torch.empty_like(x, device="meta")
    for case in (c for c in C.CASES if c.kind == "static"):
        live = C.broken(_CLEAN, _TENG, case)
        errors = T.check_state(live, _TENG, where="H100 state")
        assert errors, case.name
        assert T.check_state({k: meta(v) for k, v in live.items()}, _TENG,
                             where="H100 state") == errors


# ----------------------------------------------------------- clean states
def _random_op(eng, state, rng, t):
    """``tests/test_schema.py``'s random public op, on the port."""
    tree = eng.tree

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))
    kind = rng.choice(["place", "cancel", "cancel_all", "step"],
                      p=[0.35, 0.1, 0.05, 0.5])
    if kind == "place":
        b = 16
        levels = rng.integers(0, tree.n_levels, b)
        nodes = [rng.integers(0, tree.nodes_at(d)) for d in levels]
        prices = rng.uniform(0.5, 9.0, b)
        tenants = rng.integers(-1, eng.n_tenants, b)
        limits = prices * rng.uniform(1.0, 1.5, b)
        state = eng.place(state, f32(prices), i32(levels), i32(nodes),
                          i32(tenants), f32(limits))
    elif kind == "cancel":
        state = eng.cancel(state, i32(rng.integers(0, eng.capacity, 8)))
    elif kind == "cancel_all":
        state = eng.cancel_all(state)
    else:
        t += float(rng.uniform(1.0, 900.0))
        b = 8
        new_bids = None
        if rng.random() < 0.7:
            levels = rng.integers(0, tree.n_levels, b)
            new_bids = {
                "price": f32(rng.uniform(0.5, 9.0, b)),
                "limit": f32(rng.uniform(0.5, 14.0, b)),
                "level": i32(levels),
                "node": i32([rng.integers(0, tree.nodes_at(d))
                             for d in levels]),
                "tenant": i32(rng.integers(-1, eng.n_tenants, b))}
        floors = None
        if rng.random() < 0.3:
            floors = tuple(
                f32(np.where(rng.random(tree.nodes_at(d)) < 0.2,
                             rng.uniform(0.0, 6.0, tree.nodes_at(d)), -1.0))
                for d in range(tree.n_levels))
        relinquish = None
        if rng.random() < 0.3:
            relinquish = i32(rng.integers(-1, tree.n_leaves, 4))
        limits = None
        if rng.random() < 0.3:
            lim = rng.uniform(1.0, 20.0, tree.n_leaves)
            limits = f32(np.where(rng.random(tree.n_leaves) < 0.8, np.nan,
                                  lim))
        state, _, _ = eng.step(state, t, new_bids, floors, relinquish,
                               limits)
    return state, t, kind


@pytest.mark.parametrize("seed", [0, 7])
def test_clean_trace_states_pass_both(seed):
    rng = np.random.default_rng(seed)
    state, t = _TENG.init_state(), 0.0
    kinds = set()
    for i in range(25):
        state, t, kind = _random_op(_TENG, state, rng, t)
        kinds.add(kind)
        assert T.failed_checks(state, _TENG) == [], (i, kind)
        assert _port_error(state) is None, (i, kind)
        assert _ref_error(state) is None, (i, kind)
    assert {"place", "step"} <= kinds and int(state["waves"]) > 0


def test_clean_case_state_passes_both():
    assert _port_error(_CLEAN) is None and _ref_error(_CLEAN) is None
    live = _CLEAN["price"] > C.NEG / 2
    assert int(live.sum()) >= 2 and int((_CLEAN["owner"] >= 0).sum()) > 0


# ------------------------------------------------------------ break cases
@pytest.mark.parametrize("case", C.CASES, ids=[c.name for c in C.CASES])
def test_break_case_matches_reference(case):
    state = C.broken(_CLEAN, _TENG, case)
    got, want = _port_error(state), _ref_error(state)
    assert want is not None, "the reference passed the broken state"
    assert got is not None, f"the port passed; the reference: {want}"
    assert str(got) == str(want)
    assert case.expect in str(got)
    if case.kind == "runtime":
        assert isinstance(got, T.StateInvariantError)
        assert str(got) == f"{got.check} (`check` failed)"
    else:
        assert type(got) is AssertionError
        assert str(got).startswith("state schema violation:\n  ")


def test_order_indices_wrap_like_the_reference():
    """The reference's ``.at[order].add(1, mode="drop")`` wraps a
    negative index once before it drops: ``-1`` in ``order`` counts for
    slot ``cap - 1`` (a valid state for both), ``-cap - 1`` drops (a
    broken permutation for both)."""
    order = _CLEAN["order"]
    j = int(torch.nonzero(order == CAP - 1)[0])
    for alias, fails in ((-1, False), (-CAP - 1, True)):
        state = dict(_CLEAN)
        o = order.clone()
        o[j] = alias
        state["order"] = o
        got, want = _port_error(state), _ref_error(state)
        assert (got is not None) == fails == (want is not None)
        if fails:
            assert str(got) == str(want)


def test_validate_reads_the_host_once(monkeypatch):
    """Every predicate stays on the device until one stacked read."""
    reads = []
    for name in ("tolist", "item", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        fn = getattr(torch.Tensor, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            reads.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    T.validate_state(_CLEAN, _TENG)
    assert reads == ["tolist"]


# --------------------------------------------------------- the env gate
class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


class _Untouchable(dict):
    def __getitem__(self, key):
        raise AssertionError(f"the unset hook read state[{key!r}]")


@pytest.mark.parametrize("value", [None, "", "0"])
def test_maybe_validate_is_env_gated(monkeypatch, value):
    corrupt = C.broken(_CLEAN, _TENG, C.CASES[0])
    if value is None:
        monkeypatch.delenv(T.VALIDATE_ENV, raising=False)
    else:
        monkeypatch.setenv(T.VALIDATE_ENV, value)
    before = T.VALIDATED
    with _CountOps() as ops:
        T.maybe_validate(corrupt, _TENG)
        T.maybe_validate(_Untouchable(corrupt), _TENG)
    assert ops.ops == 0 and T.VALIDATED == before
    J.maybe_validate(to_numpy(corrupt), _JENG)      # the reference: no-op
    monkeypatch.setenv(T.VALIDATE_ENV, "1")
    with pytest.raises(T.StateInvariantError, match="hole convention"):
        T.maybe_validate(corrupt, _TENG)
    assert T.VALIDATED == before + 1
    with _CountOps() as ops:
        T.maybe_validate(_CLEAN, _TENG)
    assert ops.ops > 0


# ------------------------------------------------------------- the hooks
@pytest.fixture
def hook_log(monkeypatch):
    """Turns the hook on and records ``where`` of every state it
    validated (each validated for real) in ``log["validated"]``, and the
    publishes and steps of the four hooked sites in ``log["sites"]``."""
    log = {"validated": [], "sites": []}
    real = T.validate_state

    def recording(state, engine, where="state"):
        log["validated"].append(where)
        real(state, engine, where=where)
    monkeypatch.setenv(T.VALIDATE_ENV, "1")
    monkeypatch.setattr(T, "validate_state", recording)
    for cls, name in ((EpochRunner, "drive"), (TR.CrashSafeRunner,
                                                "_publish"),
                      (BatchMarket, "_step"), (BatchMarket, "step_arrays")):
        def counted(*a, _fn=getattr(cls, name), _name=name, **kw):
            log["sites"].append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(cls, name, counted)
    return log


def test_epoch_runner_publish_validates_once(hook_log):
    """``run_fleet_scenario`` seeds the root floor (one facade step),
    then drives the epochs (one publish)."""
    res = TS.run_fleet_scenario(TS.FleetScenarioConfig(**FCFG), "cpu")
    assert len(res.epoch_s) == 6
    assert hook_log["sites"] == ["_step", "drive"]
    assert hook_log["validated"] == ["H100 state"] * 2


def test_crash_safe_runner_publish_validates_once(hook_log, tmp_path):
    topo, _, market, fleet, params = TS.make_fleet(
        TS.FleetScenarioConfig(**FCFG), "cpu")
    TS._seed_floors(market, topo)
    runner = TR.CrashSafeRunner(market, fleet, "H100", str(tmp_path),
                                snapshot_every=2)
    runner.run(params, FCFG["duration_s"], FCFG["tick_s"])
    assert hook_log["sites"] == ["_step", "_publish"]
    runner.resume(params, FCFG["duration_s"], FCFG["tick_s"])
    assert hook_log["sites"] == ["_step", "_publish", "_publish"]
    assert hook_log["validated"] == ["H100 state"] * 3


def test_facade_steps_validate_once_each(hook_log):
    topo = build_cluster({"H100": 16}, gpus_per_host=4, hosts_per_rack=2,
                         racks_per_zone=2)
    trace = market_trace(Market(topo), 0, 40)
    bm = BatchMarket(topo, capacity=1 << 8, n_tenants=8, device="cpu")
    for e in trace:
        apply_event(bm, e)
    n = len(hook_log["sites"])
    assert n > len(trace) // 2 and set(hook_log["sites"]) == {"_step"}
    assert hook_log["validated"] == ["H100 state"] * n
    # the fleet's array-native step
    bids = {"price": torch.tensor([9.0, 8.0]),
            "limit": torch.tensor([12.0, 12.0]),
            "level": torch.tensor([4, 0], dtype=torch.int32),
            "node": torch.tensor([0, 3], dtype=torch.int32),
            "tenant": torch.tensor([1, 2], dtype=torch.int32)}
    for i in range(3):
        bm.step_arrays("H100", bm.now + 60.0 * (i + 1), bids)
    assert hook_log["sites"][n:] == ["step_arrays"] * 3
    assert hook_log["validated"] == ["H100 state"] * (n + 3)


def test_hook_raises_on_a_broken_published_state(hook_log):
    topo = build_cluster({"H100": 16}, gpus_per_host=4, hosts_per_rack=2,
                         racks_per_zone=2)
    bm = BatchMarket(topo, capacity=1 << 8, n_tenants=8, device="cpu")
    st = dict(bm.states["H100"])
    st["bills"] = torch.full_like(st["bills"], float("nan"))
    bm.states["H100"] = st
    with pytest.raises(T.StateInvariantError, match="bill vector"):
        bm.advance_to(60.0)
    assert hook_log["validated"] == ["H100 state"]


def test_hooks_unset_validate_nothing(monkeypatch, tmp_path):
    monkeypatch.delenv(T.VALIDATE_ENV, raising=False)

    def never(*a, **kw):
        raise AssertionError("validate_state ran with the hook unset")
    monkeypatch.setattr(T, "validate_state", never)
    before = T.VALIDATED
    TS.run_fleet_scenario(TS.FleetScenarioConfig(**FCFG), "cpu")
    topo, _, market, fleet, params = TS.make_fleet(
        TS.FleetScenarioConfig(**FCFG), "cpu")
    TS._seed_floors(market, topo)
    TR.CrashSafeRunner(market, fleet, "H100", str(tmp_path)).run(
        params, FCFG["duration_s"], FCFG["tick_s"])
    market.advance_to(1e4)
    assert T.VALIDATED == before
