"""Parity of the port's Fig 6 fleet pieces with the JAX reference on the
CPU: the retention denominator (``_alone_perf`` under ``"engine"`` and
``"engine_sampled"``), ``run_fleet_scenario`` with an engine-driven
denominator (its engine state must stay the multi-tenant run's), the
fcfs / fcfsp / spot fleet baselines, and ``SpotBook`` under random op
traces.  All at the toy size of ``tests/test_fig06_calibration.py``'s
sampled-denominator test: 32 leaves, 2/2/1 tenants, 900 s.

One reference fleet and market serve every test, so its jitted programs
compile once; its multi-tenant run goes through the reference's
six-dispatch loop, which the reference's own tests pin bit-identical to
its fused epoch.
"""
import gc

import jax
import numpy as np
import pytest
import torch

from repro.sim import cloud as J_cloud
from repro.sim import fleet_baselines as J_base
from repro.sim import simulator as S
from repro_torch.convert import to_numpy
from repro_torch.sim import cloud as T_cloud
from repro_torch.sim import fleet_baselines as T_base
from repro_torch.sim import simulator as TS

torch.set_num_threads(1)     # small tensors; leave the cores to XLA

TOY = dict(regime="heavy", n_leaves=32, n_training=2, n_inference=2,
           n_batch=1, duration_s=900.0, seed=1, b_max=32)
ALONE = {"engine": dict(alone="engine"),
         "sampled1": dict(alone="engine_sampled", alone_sample=1),
         "sampled64": dict(alone="engine_sampled", alone_sample=64)}


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends (see
    ``tests/test_torch_fleet.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _fresh_port_cache(monkeypatch):
    """Every test computes the port's denominator itself."""
    monkeypatch.setattr(TS, "_ALONE_CACHE", {})


def _ref_cfg(**kw):
    return S.FleetScenarioConfig(**TOY, **kw)


def _port_cfg(**kw):
    return TS.FleetScenarioConfig(**TOY, **kw)


@pytest.fixture(scope="module")
def ref():
    """The reference's toy objects, its denominators and its
    multi-tenant run."""
    fcfg = _ref_cfg(alone="analytic")
    topo, _, market, fleet, params = S.make_fleet(fcfg)
    alone = {"none": np.ones(fcfg.n_tenants, np.float32),
             "analytic": S._alone_analytic(fleet, params, fcfg)}
    for name, kw in ALONE.items():
        alone[name] = S._alone_perf(fleet, params, market, topo,
                                    _ref_cfg(**kw))
    market.reset()
    S._seed_floors(market, topo)
    state, _, clipped = S._drive_fleet(fleet, params, market, fcfg,
                                       time_epochs=False)
    stats = dict(market.stats)
    stats["bids_clipped"] = clipped
    return dict(topo=topo, market=market, fleet=fleet, params=params,
                alone=alone, stats=stats,
                perf=np.asarray(fleet.performance(params, state,
                                                  fcfg.duration_s)),
                est=jax.tree_util.tree_map(np.asarray,
                                           market.states["H100"]))


@pytest.fixture(scope="module")
def port():
    topo, _, market, fleet, params = TS.make_fleet(_port_cfg(), "cpu")
    return dict(topo=topo, market=market, fleet=fleet, params=params)


def _assert_tree_equal(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=where)


# ---------------------------------------------------------- denominator
@pytest.mark.parametrize("mode", sorted(ALONE))
def test_alone_perf_matches_reference(ref, port, mode):
    """The engine-driven denominators are bit-identical; with the sample
    covering every tenant, the sampled one is the exact one."""
    waves = []
    got = TS._alone_perf(port["fleet"], port["params"], port["market"],
                         port["topo"], _port_cfg(**ALONE[mode]), waves)
    np.testing.assert_array_equal(got, ref["alone"][mode])
    n_runs = {"engine": 5, "sampled1": 3, "sampled64": 5}[mode]
    assert len(waves) == n_runs and min(waves) > 0
    if mode == "sampled64":
        np.testing.assert_array_equal(got, ref["alone"]["engine"])


def test_alone_cache_is_keyed_by_config_and_device(port):
    """A cached denominator is reused for the same configuration on the
    same device, and only there."""
    cfg = _port_cfg(alone="analytic")
    args = (port["fleet"], port["params"], port["market"], port["topo"])
    first = TS._alone_perf(*args, cfg)
    assert list(TS._ALONE_CACHE) == [(repr(cfg), "cpu")]
    TS._ALONE_CACHE[(repr(cfg), "cuda:0")] = np.zeros_like(first)
    np.testing.assert_array_equal(TS._alone_perf(*args, cfg), first)


@pytest.mark.parametrize("mode", ["none", "analytic", "engine",
                                  "sampled1"])
def test_run_fleet_scenario_matches_reference(ref, mode):
    """Perf, retention, stats and the engine state equal the reference's
    multi-tenant run for every denominator, though the engine-driven
    ones reset the market once a tenant after that run."""
    kw = ALONE.get(mode, dict(alone=mode))
    res = TS.run_fleet_scenario(_port_cfg(**kw), device="cpu")
    _assert_tree_equal(ref["est"], to_numpy(res.engine_state),
                       "engine_state")
    np.testing.assert_array_equal(res.perf, ref["perf"])
    assert res.stats == ref["stats"]
    alone = ref["alone"][mode]
    np.testing.assert_array_equal(res.alone_perf, alone)
    np.testing.assert_array_equal(
        res.retention, np.minimum(1.5, ref["perf"]
                                  / np.maximum(alone, 1e-9)))
    engine_runs = {"engine": 5, "sampled1": 3}.get(mode, 0)
    assert len(res.alone_waves) == engine_runs


def test_baseline_refuses_unknown_alone_mode():
    with pytest.raises(ValueError, match="alone"):
        T_base.run_fleet_baseline("fcfs", _port_cfg(alone="exact"),
                                  device="cpu")


# ------------------------------------------------------------ baselines
@pytest.mark.parametrize("kind", ["fcfs", "fcfsp", "spot"])
def test_run_fleet_baseline_matches_reference(ref, kind):
    """The reference's ``run_fleet_baseline`` on its shared toy fleet
    (``_drive``, then the sampled denominator) against the port's."""
    state, stats = J_base._drive(kind, ref["fleet"], ref["params"],
                                 _ref_cfg())
    perf = np.asarray(ref["fleet"].performance(ref["params"], state,
                                               TOY["duration_s"]))
    alone = ref["alone"]["sampled1"]
    res = T_base.run_fleet_baseline(kind, _port_cfg(**ALONE["sampled1"]),
                                    device="cpu")
    np.testing.assert_array_equal(res.perf, perf)
    np.testing.assert_array_equal(res.alone_perf, alone)
    np.testing.assert_array_equal(
        res.retention, np.minimum(1.5, perf / np.maximum(alone, 1e-9)))
    assert res.stats == {k: float(v) for k, v in stats.items()}
    assert res.stats["grants"] > 0
    if kind != "fcfs":
        assert res.stats["preemptions"] > 0


def test_unknown_baseline_raises():
    with pytest.raises(ValueError, match="baseline"):
        T_base.run_fleet_baseline("lottery", _port_cfg(), device="cpu")


# -------------------------------------------------------------- SpotBook
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spot_book_matches_reference(seed):
    """A random op trace (requests, cancels, releases, clears, queries)
    through both books gives equal returns, prices and stats."""
    rng = np.random.default_rng(seed)
    leaves = list(range(3, 3 + int(rng.integers(4, 12))))
    books = [mod.SpotBook(leaves, 2.0, notice_s=float(rng.choice([0, 60])))
             for mod in (J_cloud, T_cloud)]
    tenants = ["a", "b", "c", "d"]
    now = 0.0
    for _ in range(300):
        op = rng.choice(["request", "request", "cancel", "release",
                         "clear", "query"])
        ten = str(rng.choice(tenants))
        if op == "request":
            bid = float(np.round(rng.uniform(1.0, 5.0), 1))
            out = [b.request(ten, bid) for b in books]
        elif op == "cancel":
            k = int(rng.integers(0, 3))
            out = [b.cancel_newest(ten, k) for b in books]
        elif op == "release":
            leaf = int(rng.choice(leaves))
            out = [b.release(leaf) for b in books]
        elif op == "clear":
            now += float(rng.choice([30.0, 60.0]))
            out = [b.clear(now) for b in books]
        else:
            out = [(b.held(ten), b.open_requests(ten), b.spot,
                    [b.bill_rate(leaf) for leaf in leaves]) for b in books]
        assert out[0] == out[1], (op, out)
        assert books[0].stats == books[1].stats
        assert books[0].owner == books[1].owner
        assert books[0].notice == books[1].notice
    assert books[1].stats["grants"] > 0
