"""The port's effect contract (``repro_torch.market_torch.schema``
``EFFECTS``, ``trace_effects``, ``trace_epoch``) against the reference's
(``repro.market_jax.schema``) on the CPU.

``EFFECTS`` declares the reference's read and write sets under the
port's qualnames.  ``trace_effects`` runs an engine op, diffs every
state buffer against a copy taken before, and raises the reference's
message for an undeclared write; a write to the bid book or its sorted
view goes through ``validate_state``.  The cases are
``tests/test_effects.py``'s runtime ones: a live batch placed, a step,
``cancel_all``; and ``cancel`` (of a live order) and ``set_health``
beside them.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.market_jax import schema as J
from repro.market_jax.engine import BatchEngine as JEngine
from repro.market_jax.engine import build_tree as jbuild_tree
from repro_torch.market_torch import schema as T
from repro_torch.market_torch.engine import BatchEngine, build_tree

torch.set_num_threads(1)
_JENG = JEngine(jbuild_tree(16), capacity=32, n_tenants=4, k=2)
_TENG = BatchEngine(build_tree(16), capacity=32, n_tenants=4, k=2,
                    device="cpu")
_PFX = "repro_torch.market_torch.engine.BatchEngine."


@pytest.fixture(autouse=True)
def _release_jax_programs():
    yield
    jax.clear_caches()
    gc.collect()


def _port_name(qualname: str) -> str:
    for ref, port in (("repro.market_jax.", "repro_torch.market_torch."),
                      ("repro.sim.", "repro_torch.sim."),
                      ("repro.kernels.", "repro_torch.kernels.")):
        if qualname.startswith(ref):
            return port + qualname[len(ref):]
    raise AssertionError(qualname)


def test_effects_equal_reference():
    """Every entry of the reference's ``EFFECTS`` under the port's
    qualname, its read and write sets key for key; each port qualname
    names a function of the port."""
    import importlib
    want = {_port_name(q): {k: tuple(v) for k, v in e.items()}
            for q, e in J.EFFECTS.items()}
    assert T.EFFECTS == want and len(T.EFFECTS) == 12
    for q in T.EFFECTS:
        parts = q.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            try:
                obj = importlib.import_module(".".join(parts[:cut]))
            except ImportError:
                continue
            for name in parts[cut:]:
                obj = getattr(obj, name)
            assert callable(obj), q
            break
        else:
            raise AssertionError(q)


def _live_batch(b=4):
    return (np.full((b,), 3.0, np.float32), np.zeros((b,), np.int32),
            np.arange(b, dtype=np.int32), np.arange(b, dtype=np.int32),
            np.full((b,), 5.0, np.float32))


def _ref_observed(fn, state, *args):
    """The reference's ``trace_effects`` diff (its ``_flat_state_items``
    and ``np.array_equal``), returning the observed write-set."""
    before = {k: np.array(v) for k, v in J._flat_state_items(state)}
    out = fn(state, *args)
    new = out if isinstance(out, dict) else out[0]
    seen = set()
    for k, v in J._flat_state_items(new):
        old = before.get(k)
        if old is None or old.shape != np.shape(v) \
                or not np.array_equal(old, np.asarray(v)):
            seen.add(k.split("[", 1)[0])
    return out, seen


def _ops():
    """(name, the reference's call, the port's call) in trace order."""
    batch = _live_batch()
    hl, hn = np.array([0, 1], np.int32), np.array([0, 3], np.int32)
    hv = np.array([1, 1], np.int32)          # draining
    return [
        ("place", lambda s: _JENG.place(s, *map(jnp.asarray, batch)),
         lambda s: _TENG.place(s, *map(torch.from_numpy, batch))),
        ("cancel", lambda s: _JENG.cancel(s, jnp.asarray([1], jnp.int32)),
         lambda s: _TENG.cancel(s, torch.tensor([1], dtype=torch.int32))),
        ("step", lambda s: _JENG.step(s, 30.0, None, None, None),
         lambda s: _TENG.step(s, 30.0, None, None, None)),
        ("set_health", lambda s: _JENG.set_health(
            s, *map(jnp.asarray, (hl, hn, hv))),
         lambda s: _TENG.set_health(s, *map(torch.from_numpy,
                                            (hl, hn, hv)))),
        ("cancel_all", _JENG.cancel_all, _TENG.cancel_all)]


def test_observed_write_sets_equal_reference():
    """Each op's observed write-set on the port equals the reference's
    on the same inputs, is within its declared set, and the traced ops
    validate where they write the book."""
    jst, tst = _JENG.init_state(), _TENG.init_state()
    record = []
    for name, jop, top in _ops():
        out, want = _ref_observed(lambda s: jop(s), jst)
        jst = out if isinstance(out, dict) else out[0]
        out = T.trace_effects(top, tst, qualname=_PFX + name, engine=_TENG,
                              record=record)
        tst = out if isinstance(out, dict) else out[0]
        assert record[-1] == (_PFX + name, sorted(want)), name
        assert want, name
    T.validate_state(tst, _TENG, where="trace end")


def test_undeclared_write_raises_reference_message():
    def sneaky(st):
        st = dict(st)
        st["waves"] = st["waves"] + 1
        return st
    msgs = []
    for mod, eng, q in ((J, _JENG, "repro.market_jax.engine."
                         "BatchEngine.cancel"), (T, _TENG, _PFX + "cancel")):
        with pytest.raises(AssertionError, match="undeclared") as e:
            mod.trace_effects(sneaky, eng.init_state(), qualname=q)
        msgs.append(str(e.value).replace(q, "<q>"))
    assert msgs[0] == msgs[1]
    with pytest.raises(KeyError):
        T.trace_effects(lambda s: s, _TENG.init_state(),
                        qualname="BatchEngine.nope")


def test_stale_sorted_view_fails_validation():
    """A live order written straight into the bid table (a declared
    write of ``place``, with no sorted-view maintenance) passes the
    write-set check and fails ``validate_state`` with the reference's
    message."""
    vals = {"price": 3.0, "blimit": 5.0, "level": 0, "node": 0, "tenant": 1,
            "seq": 0}

    def jwrite(st):
        st = dict(st, next_seq=st["next_seq"] + 1)
        for k, v in vals.items():
            st[k] = st[k].at[0].set(v)
        return st

    def twrite(st):
        st = dict(st, next_seq=st["next_seq"] + 1)
        for k, v in vals.items():
            st[k] = st[k].clone()
            st[k][0] = v
        return st
    q = "BatchEngine.place"
    with pytest.raises(ValueError) as want:
        J.trace_effects(jwrite, _JENG.init_state(),
                        qualname="repro.market_jax.engine." + q, engine=_JENG)
    with pytest.raises(T.StateInvariantError) as got:
        T.trace_effects(twrite, _TENG.init_state(), qualname=_PFX + "place",
                        engine=_TENG)
    assert str(got.value) == str(want.value)
    assert "sorted view" in str(got.value) or "seg_start" in str(got.value)


def test_in_place_write_is_seen():
    """The snapshot is a copy: a function that writes a buffer in place
    and returns the same dict is caught."""
    def in_place(st):
        st["waves"].add_(1)
        return st
    with pytest.raises(AssertionError, match=r"\['waves'\]"):
        T.trace_effects(in_place, _TENG.init_state(), qualname=_PFX + "cancel")


def test_traced_epoch_writes_within_declared():
    """One fleet epoch through ``trace_epoch`` (the 16-leaf fleet of
    ``tests/test_effects.py``'s gating test): ``EpochRunner.epoch`` and the
    engine step inside it write only declared keys, the step writes the
    book, and the result equals the untraced epoch's."""
    from repro_torch.sim.epoch import EpochRunner
    from repro_torch.sim.simulator import (FleetScenarioConfig,
                                           _seed_floors, make_fleet)
    from repro_torch.market_torch.schema import STAT_KEYS
    fcfg = FleetScenarioConfig(
        regime="heavy", n_leaves=16, n_training=2, n_inference=2,
        n_batch=1, duration_s=120.0, tick_s=60.0, seed=5, k=2, b_max=32,
        per_tenant_bids=2, alone="none")
    runs = []
    for traced in (False, True):
        topo, _, market, fleet, params = make_fleet(fcfg, device="cpu")
        _seed_floors(market, topo)
        runner = EpochRunner(market, fleet, "H100")
        est = dict(market.states["H100"])
        est["floor"], est["floor_t"] = tuple(est["floor"]), \
            tuple(est["floor_t"])
        stats = {k: torch.zeros((), dtype=torch.int32) for k in STAT_KEYS}
        fst = fleet.init_state(params)
        record = []
        for t in (0.0, 60.0):
            args = (params, est, fst, stats, t)
            est, fst, stats = T.trace_epoch(runner, *args, record=record) \
                if traced else runner.epoch(*args)
        runs.append((est, fst, stats, record))
    rec = runs[1][3]
    assert [q for q, _ in rec] == [_PFX + "step",
                                   "repro_torch.sim.epoch.EpochRunner.epoch"
                                   ] * 2
    for q, seen in rec:
        assert set(seen) <= set(T.EFFECTS[q]["writes"])
    assert {"owner", "seq", "sorted_gseg"} <= set().union(
        *(seen for q, seen in rec if q == _PFX + "step"))
    for a, b in zip(runs[0][:3], runs[1][:3]):
        for (k, x), (_, y) in zip(T._flat_state_items(a),
                                  T._flat_state_items(b)):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), k
