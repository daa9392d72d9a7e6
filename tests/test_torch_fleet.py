"""Parity of the port's fleet path (``repro_torch.sim``) with the JAX
reference ``repro.sim``: the fleet functions elementwise, the whole
slice (``run_fleet_scenario``) at a small size, a run carried across
from the reference mid-way, device resolution, and the import rule
(the port, ``chip_smoke.py`` and ``profile_epoch.py`` import neither
``jax`` nor ``repro``).

JAX compiles are the cost here, so the reference run and its jitted
epoch are built once per module and shared.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import fleet as S_fleet
from repro.sim import simulator as S
from repro.sim.epoch import EpochRunner as JEpochRunner
from repro_torch.convert import to_numpy, to_torch
from repro_torch.device import resolve_device
from repro_torch.market_torch.engine import BatchEngine, build_tree
from repro_torch.sim import fleet as T_fleet
from repro_torch.sim import simulator as TS
from repro_torch.sim.epoch import EpochRunner as TEpochRunner

ROOT = pathlib.Path(__file__).resolve().parents[1]
torch.set_num_threads(1)     # small tensors; leave the cores to XLA

# the tests/test_epoch.py size
SMALL = dict(regime="heavy", n_leaves=256, n_training=6, n_inference=6,
             n_batch=4, duration_s=900.0, tick_s=60.0, seed=3, k=8,
             b_max=128, per_tenant_bids=4)


def _equal(a, b, name):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                  err_msg=name)


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
        _equal(a, b, where)


@pytest.fixture(scope="module")
def ref_fleet():
    """The reference's small fleet objects (no run: cheap to build)."""
    fcfg = S.FleetScenarioConfig(alone="analytic", **SMALL)
    topo, _, market, fleet, params = S.make_fleet(fcfg)
    return dict(fcfg=fcfg, topo=topo, market=market, fleet=fleet,
                params=params)


@pytest.fixture(scope="module")
def ref_run(ref_fleet):
    """The reference's small fleet run, mirroring its
    ``run_fleet_scenario`` step by step so the jitted epoch (and its
    runner) can be reused by the carry-across test."""
    fcfg, topo, market, fleet, params = (
        ref_fleet[k] for k in ("fcfg", "topo", "market", "fleet", "params"))
    S._seed_floors(market, topo)
    runner = JEpochRunner(market, fleet)
    fstate = fleet.init_state(params)
    fstate, _, hstats = runner.drive(params, fstate, fcfg.duration_s,
                                     fcfg.tick_s, time_epochs=False)
    perf = np.asarray(fleet.performance(params, fstate, fcfg.duration_s))
    stats = dict(market.stats)
    stats["bids_clipped"] = hstats["bids_clipped"]
    alone = S._alone_analytic(fleet, params, fcfg)
    est = jax.tree_util.tree_map(np.asarray, market.states["H100"])
    return dict(ref_fleet, runner=runner, perf=perf, stats=stats,
                alone=alone, est=est)


@pytest.fixture(scope="module")
def port_small():
    fcfg = TS.FleetScenarioConfig(alone="none", **SMALL)
    topo, tenants, market, fleet, params = TS.make_fleet(fcfg, "cpu")
    return dict(fcfg=fcfg, topo=topo, market=market, fleet=fleet,
                params=params)


def test_params_match_reference(ref_fleet, port_small):
    _assert_tree_equal(jax.tree_util.tree_map(np.asarray,
                                              ref_fleet["params"]),
                       to_numpy(port_small["params"]), "params")


# ---------------------------------------------------------------- fleet ops
def _random_fleet_state(params, rng, t):
    """A plausible mid-run fleet state (numpy), drawn from a seed."""
    n = params["kind"].shape[0]
    arr = np.asarray(params["arrival_s"])

    def u(lo, hi):
        return rng.uniform(lo, hi, n).astype(np.float32)
    done = rng.random(n) < 0.15
    return {
        "progress": u(0, 3), "served": u(0, 5e4), "demanded": u(1, 6e4),
        "rate_ewma": u(0, 60),
        "reconfig_until": np.where(rng.random(n) < 0.4, t + u(-60, 300),
                                   -1.0).astype(np.float32),
        "last_checkpoint": np.minimum(arr, t - u(0, 400)).astype(
            np.float32),
        "last_t": np.where(rng.random(n) < 0.8, t - 60.0, arr).astype(
            np.float32),
        "last_scale_down": (t - u(0, 300)).astype(np.float32),
        "done_at": np.where(done, t - 100.0, np.inf).astype(np.float32),
        "cold_cnt": rng.integers(0, 4, n).astype(np.float32),
        "cold_until": (t + u(-120, 120)).astype(np.float32),
    }


def _random_leaf_inputs(n, n_leaves, n_levels_nodes, rng):
    owner = np.where(rng.random(n_leaves) < 0.8,
                     rng.integers(0, n, n_leaves), -1).astype(np.int32)
    rate = np.where(owner >= 0, rng.uniform(3.0, 12.0, n_leaves),
                    0.0).astype(np.float32)
    rate[::7] = np.round(rate[::7])     # ties in the surplus ranking
    floors = tuple(np.where(rng.random(m) < 0.5, rng.uniform(0, 4, m),
                            0.0).astype(np.float32)
                   for m in n_levels_nodes)
    return owner, rate, floors


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_ops_match_reference(ref_fleet, port_small, seed):
    """``policy``, ``after_step`` and ``advance`` elementwise on the same
    random mid-run states."""
    rng = np.random.default_rng(100 + seed)
    jf, tf = ref_fleet["fleet"], port_small["fleet"]
    jp, tp = ref_fleet["params"], port_small["params"]
    tree = tf.tree
    n = tf.cfg.n
    t = float(rng.choice([240.0, 480.0, 600.0]))
    fs = _random_fleet_state(jp, rng, t)
    owner, rate, floors = _random_leaf_inputs(
        n, tree.n_leaves, [tree.nodes_at(d) for d in range(tree.n_levels)],
        rng)
    jfs = jax.tree_util.tree_map(jnp.asarray, fs)
    tfs = to_torch(fs, "cpu")
    j_out = jf.policy(jp, jfs, t, jnp.asarray(owner), jnp.asarray(rate),
                      tuple(jnp.asarray(f) for f in floors))
    t_out = tf.policy(tp, tfs, t, torch.from_numpy(owner),
                      torch.from_numpy(rate),
                      tuple(torch.from_numpy(f) for f in floors))
    for name, a, b in zip(("limits", "relinquish", "sel", "bids",
                           "state", "info"), j_out, t_out):
        _assert_tree_equal(jax.tree_util.tree_map(np.asarray, a),
                           to_numpy(b), f"policy.{name}")
    sel = np.asarray(j_out[2])
    owner_after = np.where(rng.random(tree.n_leaves) < 0.3,
                           rng.integers(-1, n, tree.n_leaves),
                           owner).astype(np.int32)
    j_st, j_held = jf.after_step(jp, jfs, t, jnp.asarray(owner),
                                 jnp.asarray(owner_after), jnp.asarray(sel))
    t_st, t_held = tf.after_step(tp, tfs, t, torch.from_numpy(owner),
                                 torch.from_numpy(owner_after),
                                 torch.tensor(sel))
    _assert_tree_equal(jax.tree_util.tree_map(np.asarray, j_st),
                       to_numpy(t_st), "after_step.state")
    _equal(j_held, t_held.numpy(), "after_step.held")
    held = rng.integers(0, 20, n).astype(np.int32)
    _assert_tree_equal(
        jax.tree_util.tree_map(np.asarray,
                               jf.advance(jp, jfs, t, jnp.asarray(held))),
        to_numpy(tf.advance(tp, tfs, t, torch.from_numpy(held))),
        "advance")
    _equal(jf.performance(jp, jfs, t),
           tf.performance(tp, tfs, t).numpy(), "performance")
    j_rs = jf.resize_to_desired(jp, jfs, t, jnp.asarray(held))
    t_rs = tf.resize_to_desired(tp, tfs, t, torch.from_numpy(held))
    _assert_tree_equal(jax.tree_util.tree_map(np.asarray, j_rs),
                       to_numpy(t_rs), "resize_to_desired")
    tenant_rate = rng.uniform(0.0, 12.0, n).astype(np.float32)
    _assert_tree_equal(
        jax.tree_util.tree_map(np.asarray, jf.listing1(
            jp, jfs, jnp.asarray(held), jnp.float32(2.5),
            jnp.asarray(tenant_rate))),
        to_numpy(tf.listing1(tp, tfs, torch.from_numpy(held),
                             torch.tensor(2.5),
                             torch.from_numpy(tenant_rate))), "listing1")
    _assert_tree_equal(
        jax.tree_util.tree_map(np.asarray, jf.apply_policy_log(
            jfs, t, jnp.asarray(owner), jnp.asarray(sel))),
        to_numpy(tf.apply_policy_log(tfs, t, torch.from_numpy(owner),
                                     torch.tensor(sel))),
        "apply_policy_log")
    i = int(rng.integers(0, n))
    _equal(S_fleet.params_alone(jp, i)["arrival_s"],
           T_fleet.params_alone(tp, i)["arrival_s"].numpy(),
           "params_alone")


# ------------------------------------------------------------ whole slice
@pytest.mark.parametrize("alone", ["none", "analytic"])
def test_run_fleet_scenario_matches_reference(ref_run, alone):
    """The whole slice at the tests/test_epoch.py size: owners, rates,
    bills and the whole engine state, perf, retention and stats are
    identical (bills too: the port adds each tenant's accruals in leaf
    order, as the reference's CPU scatter does)."""
    res = TS.run_fleet_scenario(
        TS.FleetScenarioConfig(alone=alone, **SMALL), device="cpu")
    est = to_numpy(res.engine_state)
    _assert_tree_equal(ref_run["est"], est, "engine_state")
    _equal(ref_run["perf"], res.perf, "perf")
    assert res.stats == ref_run["stats"]
    alone_ref = ref_run["alone"] if alone == "analytic" \
        else np.ones_like(ref_run["alone"])
    _equal(alone_ref, res.alone_perf, "alone_perf")
    _equal(np.minimum(1.5, ref_run["perf"]
                      / np.maximum(alone_ref, 1e-9)),
           res.retention, "retention")
    assert res.stats["orders"] > 0 and res.stats["transfers"] > 0
    assert int(est["waves"]) > 0


def test_carry_across_from_reference(ref_run, port_small):
    """Run the reference 5 epochs, carry its state across, then run both
    5 more epochs: every state key and stat stays identical."""
    market, fleet, params = (ref_run["market"], ref_run["fleet"],
                             ref_run["params"])
    runner = ref_run["runner"]
    market.reset()
    S._seed_floors(market, ref_run["topo"])
    est = dict(market.states["H100"])
    est["floor"], est["floor_t"] = tuple(est["floor"]), \
        tuple(est["floor_t"])
    stats = {k: jnp.zeros((), jnp.int32) for k in
             ("orders", "transfers", "explicit_relinquish",
              "implicit_relinquish", "bids_clipped", "revoked_by_fault")}
    fstate = fleet.init_state(params)
    # donated arguments must not alias: private copies, as drive makes
    est, fstate, stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).copy(), (est, fstate, stats))
    times = [60.0 * i for i in range(10)]
    for t in times[:5]:
        est, fstate, stats = runner.epoch(params, est, fstate, stats,
                                          jnp.float32(t))
    mid = jax.tree_util.tree_map(np.asarray, (est, fstate, stats))
    tm = port_small["market"]
    trunner = TEpochRunner(tm, port_small["fleet"])
    t_est, t_fs, t_stats = to_torch(mid, "cpu")
    for t in times[5:]:
        est, fstate, stats = runner.epoch(params, est, fstate, stats,
                                          jnp.float32(t))
        t_est, t_fs, t_stats = trunner.epoch(port_small["params"], t_est,
                                             t_fs, t_stats, t)
    _assert_tree_equal(jax.tree_util.tree_map(np.asarray,
                                              (est, fstate, stats)),
                       to_numpy((t_est, t_fs, t_stats)), "carried")


# ------------------------------------------------------------- contracts
def test_device_none_means_cuda():
    """Entry points default to CUDA and raise without it — never a quiet
    run on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        BatchEngine(build_tree(64))
    with pytest.raises(RuntimeError):
        TS.make_fleet(TS.FleetScenarioConfig(**SMALL))
    with pytest.raises(RuntimeError):
        TS.run_fleet_scenario(TS.FleetScenarioConfig(**SMALL))


def test_engine_alone_modes_not_ported():
    for mode in ("engine", "engine_sampled"):
        with pytest.raises(NotImplementedError):
            TS.run_fleet_scenario(
                TS.FleetScenarioConfig(alone=mode, **SMALL), device="cpu")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "profile_epoch.py"]
    return files


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, chip_smoke.py and profile_epoch.py
    import no ``jax`` (or ``jaxlib``) and nothing of the ``repro``
    package."""
    banned = {"jax", "jaxlib", "repro"}
    bad = []
    files = _port_files()
    assert all(path.exists() for path in files)
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"imports {name}")
    assert not bad, "\n".join(bad)
