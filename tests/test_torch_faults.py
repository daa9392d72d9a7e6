"""Parity of the port's fault injection with the JAX reference on the
CPU: the four schedule builders, ``FaultInjector`` (health application,
crash consumption, rewind), ``BatchMarket.set_health`` at every level of
the topology, and a whole fleet run under a rack-failure storm and a
zone supply shock at the ``tests/test_epoch.py`` size.
"""
import gc

import jax
import numpy as np
import pytest
import torch

from repro.core.topology import build_cluster as j_build_cluster
from repro.market_jax import bridge as J_bridge
from repro.market_jax import engine as J_eng
from repro.sim import faults as J_faults
from repro.sim import simulator as S
from repro_torch.convert import to_numpy
from repro_torch.core.topology import build_cluster
from repro_torch.market_torch import bridge as T_bridge
from repro_torch.market_torch import engine as T_eng
from repro_torch.sim import faults as T_faults
from repro_torch.sim import simulator as TS

torch.set_num_threads(1)     # small tensors; leave the cores to XLA

# the tests/test_epoch.py size (tests/test_torch_fleet.py SMALL)
SMALL = dict(regime="heavy", n_leaves=256, n_training=6, n_inference=6,
             n_batch=4, duration_s=900.0, tick_s=60.0, seed=3, k=8,
             b_max=128, per_tenant_bids=4)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends (see
    ``tests/test_torch_fleet.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


def _assert_state_equal(ref, got):
    """Engine states key by key (the floors level by level)."""
    assert set(ref) == set(got)
    for key in ref:
        pairs = zip(ref[key], got[key]) if key in ("floor", "floor_t") \
            else [(ref[key], got[key])]
        for a, b in pairs:
            np.testing.assert_array_equal(b, a, err_msg=key)


def _fields(events):
    return [(e.t, e.kind, e.level, e.node, e.phase) for e in events]


def _storm(mod, n_leaves, duration_s):
    """``benchmarks/fig_faults.py``'s storm, built by ``mod``."""
    tree = (J_eng if mod is J_faults else T_eng).build_tree(n_leaves)
    return (mod.rack_failure_storm(tree, 120.0, duration_s * 0.6, 180.0,
                                   240.0, racks_per_burst=2, seed=7)
            + mod.zone_supply_shock(duration_s * 0.3, duration_s * 0.7,
                                    zone=0))


# ------------------------------------------------------------- schedules
BUILDERS = {
    "rack_failure_storm": lambda m, e: m.rack_failure_storm(
        e.build_tree(10000), 60.0, 600.0, 120.0, 180.0,
        racks_per_burst=3, seed=5),
    "rack_failure_storm_hosts": lambda m, e: m.rack_failure_storm(
        e.build_tree(64), 0.0, 300.0, 60.0, 90.0, racks_per_burst=9,
        seed=1, level=m.LEVEL_HOST),
    "zone_supply_shock": lambda m, e: m.zone_supply_shock(100.0, 500.0,
                                                           zone=1),
    "drain_schedule": lambda m, e: m.drain_schedule(
        [(2, 0), (2, 1), (0, 7)], 60.0, 300.0),
    "drain_schedule_open": lambda m, e: m.drain_schedule([(1, 3)], 60.0),
    "crash_schedule": lambda m, e: m.crash_schedule(
        [60.0, 120.0, 120.0], ["pre_wal", "post_wal", "post_step"]),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_schedule_builders_match_reference(name):
    want = BUILDERS[name](J_faults, J_eng)
    got = BUILDERS[name](T_faults, T_eng)
    assert len(want) > 0
    assert _fields(got) == _fields(want)


# -------------------------------------------------------------- injector
def _engines(n_leaves=64):
    tree_j, tree_t = J_eng.build_tree(n_leaves), T_eng.build_tree(n_leaves)
    eng_j = J_eng.BatchEngine(tree_j, capacity=64, n_tenants=8)
    eng_t = T_eng.BatchEngine(tree_t, capacity=64, n_tenants=8,
                              device="cpu")
    return eng_j, eng_t


def test_apply_health_matches_reference():
    """Every tick's due events (overlapping domains, later entries
    winning, a tick with more events than the scatter's pad) give the
    reference's engine state."""
    events = (_storm(J_faults, 64, 600.0)
              + J_faults.drain_schedule([(1, 2), (0, 17), (0, 40)], 240.0,
                                        420.0)
              + [J_faults.FaultEvent(300.0, "fail", 0, i)
                 for i in range(0, 64, 5)]
              + [J_faults.FaultEvent(300.0, "repair", 1, 0)])
    events_t = [T_faults.FaultEvent(e.t, e.kind, e.level, e.node, e.phase)
                for e in events]
    inj_j = J_faults.FaultInjector(events, pad=4)
    inj_t = T_faults.FaultInjector(events_t, pad=4)
    eng_j, eng_t = _engines()
    st_j, st_t = eng_j.init_state(), eng_t.init_state()
    seen = set()
    for t in np.arange(0.0, 720.0, 60.0):
        st_j = inj_j.apply_health(eng_j, st_j, float(t))
        st_t = inj_t.apply_health(eng_t, st_t, float(t))
        health = np.asarray(st_j["health"])
        np.testing.assert_array_equal(to_numpy(st_t)["health"], health,
                                      err_msg=f"t={t}")
        seen |= set(health.tolist())
    assert seen == {T_eng.HEALTH_UP, T_eng.HEALTH_DRAINING,
                    T_eng.HEALTH_DOWN}
    _assert_state_equal(jax.tree_util.tree_map(np.asarray, st_j),
                        to_numpy(st_t))


def test_injector_consumption_matches_reference():
    """due_health, due_crash (with and without a phase), rewind_to,
    reset and apply_market consume the schedule as the reference's
    injector does."""
    def schedule(mod):
        return ([mod.FaultEvent(10.0, "fail", 0, 1),
                 mod.FaultEvent(20.0, "repair", 0, 1),
                 mod.FaultEvent(20.0, "drain", 0, 2),
                 mod.FaultEvent(40.0, "fail", 1, 0)]
                + mod.crash_schedule([15.0, 30.0, 30.0],
                                     ["post_step", "pre_wal", "post_wal"]))
    injs = [mod.FaultInjector(schedule(mod))
            for mod in (J_faults, T_faults)]
    calls = [("due_health", 5.0), ("due_crash", 16.0, "pre_wal"),
             ("due_crash", 16.0, "post_step"), ("due_health", 20.0),
             ("due_crash", 31.0), ("due_crash", 31.0, "post_wal"),
             ("rewind_to", 10.0), ("due_health", 25.0),
             ("due_crash", 99.0), ("rewind_to", 30.0),
             ("due_crash", 99.0), ("due_health", 99.0), ("reset",),
             ("due_crash", 15.0), ("due_health", 99.0)]
    for name, *args in calls:
        out = [getattr(inj, name)(*args) for inj in injs]
        if name == "due_health":
            out = [_fields(o) for o in out]
        elif name == "due_crash":
            out = [o and _fields([o]) for o in out]
        assert out[0] == out[1], (name, args, out)

    mj = J_bridge.BatchMarket(j_build_cluster({"H100": 64}), n_tenants=4)
    mt = T_bridge.BatchMarket(build_cluster({"H100": 64}), n_tenants=4,
                              device="cpu")
    for market, mod in ((mj, J_faults), (mt, T_faults)):
        mod.FaultInjector(schedule(mod)).apply_market(market, "H100", 20.0)
    health = np.asarray(mj.states["H100"]["health"])
    np.testing.assert_array_equal(mt.states["H100"]["health"].numpy(),
                                  health)
    assert health[:3].tolist() == [T_eng.HEALTH_UP, T_eng.HEALTH_UP,
                                   T_eng.HEALTH_DRAINING]


def test_fault_event_rejects_unknown_kind():
    with pytest.raises(ValueError, match="fault kind"):
        T_faults.FaultEvent(0.0, "meteor")


# ---------------------------------------------------------------- bridge
@pytest.mark.parametrize("level", ["leaf", "host", "rack", "zone"])
def test_market_set_health_matches_reference(level):
    """``BatchMarket.set_health`` at a topology node of each level marks
    the same engine leaves as the reference's, then repairs part of
    them."""
    n_leaves = 300                      # a partial zone, rack and host
    topo_j = j_build_cluster({"H100": n_leaves})
    topo_t = build_cluster({"H100": n_leaves})
    depth = {"leaf": 4, "host": 3, "rack": 2, "zone": 1}[level]
    nodes = [n.node_id for n in topo_t.nodes if n.level == depth]
    assert nodes == [n.node_id for n in topo_j.nodes if n.level == depth]
    mj = J_bridge.BatchMarket(topo_j, n_tenants=4)
    mt = T_bridge.BatchMarket(topo_t, n_tenants=4, device="cpu")
    picks = [nodes[0], nodes[len(nodes) // 2], nodes[-1]]
    for node, value in zip(picks + [picks[1]],
                           [J_eng.HEALTH_DOWN, J_eng.HEALTH_DRAINING,
                            J_eng.HEALTH_DOWN, J_eng.HEALTH_UP]):
        mj.set_health(node, value)
        mt.set_health(node, value)
        np.testing.assert_array_equal(
            mt.states["H100"]["health"].numpy(),
            np.asarray(mj.states["H100"]["health"]), err_msg=str(node))
    assert (mt.states["H100"]["health"] == T_eng.HEALTH_DOWN).any()


# -------------------------------------------------------------- the fleet
def test_storm_run_matches_reference():
    """``run_fleet_scenario`` under the storm: the whole engine state,
    perf and stats equal the reference's run (its ``run_fleet_scenario``
    step by step, to read its engine state), and faults revoked
    leaves."""
    cfg_j = S.FleetScenarioConfig(
        alone="none", faults=_storm(J_faults, 256, 900.0), **SMALL)
    topo, _, market, fleet, params = S.make_fleet(cfg_j)
    S._seed_floors(market, topo)
    state, _, clipped = S._drive_fleet_fused(fleet, params, market, cfg_j,
                                             time_epochs=False)
    stats = dict(market.stats, bids_clipped=clipped)
    est = jax.tree_util.tree_map(np.asarray, market.states["H100"])
    res = TS.run_fleet_scenario(TS.FleetScenarioConfig(
        alone="none", faults=_storm(T_faults, 256, 900.0), **SMALL),
        device="cpu")
    _assert_state_equal(est, to_numpy(res.engine_state))
    np.testing.assert_array_equal(
        res.perf, np.asarray(fleet.performance(params, state,
                                               cfg_j.duration_s)))
    assert res.stats == stats
    assert res.stats["revoked_by_fault"] > 0


def test_fig_faults_n2048_nofault_matches_reference():
    """``benchmarks/fig_faults.py``'s n=2,048 nofault case (21 epochs,
    b_max 1,024, the analytic denominator): the port equals the
    reference as it stands.  Both give transfers 2,954 and retention
    0.871 where the committed ``BENCH_fig_faults.json`` row says 12,805
    and 0.143: that row predates the reference's calibrated fleet
    (docs/DESIGN.md §13: ``min_holding_s`` 600, inference cold-start
    batches), as do its n=10,000 rows."""
    kw = dict(regime="heavy", n_leaves=2048, n_training=96,
              n_inference=96, n_batch=64, duration_s=1200.0, tick_s=60.0,
              seed=1, k=16, b_max=1024, alone="analytic")
    ref = S.run_fleet_scenario(S.FleetScenarioConfig(**kw))
    res = TS.run_fleet_scenario(TS.FleetScenarioConfig(**kw), device="cpu")
    np.testing.assert_array_equal(res.perf, ref.perf)
    np.testing.assert_array_equal(res.retention, ref.retention)
    assert res.stats == ref.stats
    assert (res.stats["orders"], res.stats["transfers"],
            res.stats["revoked_by_fault"], len(res.epoch_s)) == \
        (13527, 2954, 0, 21)
    assert f"{res.mean_retention:.3f}" == "0.871"
