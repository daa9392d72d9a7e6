"""Parity of the port's crash-safe recovery (``repro_torch.sim.recovery``,
``repro_torch.checkpoint``) with the JAX reference on the CPU.

The contract under test (``tests/test_recovery.py``): a fleet run killed
at any intra-epoch phase boundary, then resumed by a fresh process from
the same workdir, ends bit-identical (owners, rates, bills, health,
performance, stats) to the uninterrupted run.  Here the port is held to
its own uninterrupted run and to the reference's, the durable files are
compared across implementations (WAL records, snapshot keys, dtypes and
values), and workdirs cross over: one the reference killed is resumed
by the port, and one the port killed is resumed by the reference.

The reference side is built by the two tests that need it, each once
(its fleet programs compile once and it is reset between its runs): a
module fixture shared by tests that land on different test workers
would be rebuilt on each.  Every other test is held to the port's
uninterrupted run, which the first of the two holds to the reference's
bit for bit; the port side costs only torch time.
"""
import gc
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JCheckpoints
from repro.market_jax import schema
from repro.market_jax.engine import build_tree as j_build_tree
from repro.sim import faults as J_faults
from repro.sim import recovery as JR
from repro.sim import simulator as S
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.convert import to_numpy
from repro_torch.market_torch.engine import build_tree
from repro_torch.sim import faults as T_faults
from repro_torch.sim import recovery as TR
from repro_torch.sim import simulator as TS
from repro_torch.sim.epoch import EpochRunner

torch.set_num_threads(1)     # small tensors; leave the cores to XLA

DUR, TICK = 600.0, 60.0        # 11 epochs
# tests/test_recovery.py's _fcfg at 64 leaves
FCFG = dict(regime="heavy", n_leaves=64, n_training=3, n_inference=3,
            n_batch=2, duration_s=DUR, tick_s=TICK, seed=3, k=4, b_max=64,
            per_tenant_bids=4, alone="none")


@pytest.fixture(autouse=True)
def _release_jax_programs():
    """Drop each test's compiled JAX programs when it ends (see
    ``tests/test_torch_fleet.py``): no test here reuses another's."""
    yield
    jax.clear_caches()
    gc.collect()


def _health_events(mod, tree):
    """``tests/test_recovery.py``'s storm and zone shock, built by
    ``mod`` (either implementation's ``sim.faults``)."""
    return (mod.rack_failure_storm(tree, 120.0, 400.0, 180.0, 150.0,
                                   seed=9)
            + mod.zone_supply_shock(240.0, 420.0, zone=0))


def _t_events(*crashes):
    return _health_events(T_faults, build_tree(64)) + [
        T_faults.FaultEvent(t, "crash", phase=ph) for t, ph in crashes]


def _j_events(*crashes):
    return _health_events(J_faults, j_build_tree(64)) + [
        J_faults.FaultEvent(t, "crash", phase=ph) for t, ph in crashes]


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fingerprint(market, fleet, params, fleet_state, stats):
    est = market.states["H100"]
    return ({k: _host(est[k]) for k in ("owner", "rate", "bills", "health")},
            _host(fleet.performance(params, fleet_state, DUR)),
            dict(stats))


def _assert_identical(a, b, ctx=""):
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k],
                                      err_msg=f"{ctx} {k}")
    np.testing.assert_array_equal(a[1], b[1], err_msg=ctx)
    assert a[2] == b[2], (ctx, a[2], b[2])


def _fresh(workdir, events, snapshot_every=1):
    """A fresh port 'process': market, fleet and params rebuilt from the
    configuration, the same durable workdir."""
    topo, _, market, fleet, params = TS.make_fleet(
        TS.FleetScenarioConfig(**FCFG), "cpu")
    TS._seed_floors(market, topo)
    runner = TR.CrashSafeRunner(market, fleet, "H100", str(workdir),
                                snapshot_every=snapshot_every,
                                injector=T_faults.FaultInjector(events))
    return runner, market, fleet, params


def _resume(workdir, events=()):
    runner, market, fleet, params = _fresh(workdir, _t_events(*events))
    fs, stats = runner.resume(params, DUR, TICK)
    return _fingerprint(market, fleet, params, fs, stats)


class _Reference:
    """The reference's fleet objects (their programs compile on first
    use); ``runner`` resets the market to its seeded initial state, as a
    restarted process has it."""

    def __init__(self):
        self.topo, _, self.market, self.fleet, self.params = S.make_fleet(
            S.FleetScenarioConfig(**FCFG))

    def runner(self, workdir, events):
        self.market.reset()
        S._seed_floors(self.market, self.topo)
        return JR.CrashSafeRunner(self.market, self.fleet, "H100",
                                  str(workdir),
                                  injector=J_faults.FaultInjector(events))

    def fingerprint(self, fs, stats):
        return _fingerprint(self.market, self.fleet, self.params, fs,
                            stats)


@pytest.fixture(scope="module")
def port_base(tmp_path_factory):
    """The port's uninterrupted run (fingerprint and workdir)."""
    wd = tmp_path_factory.mktemp("port_recovery") / "base"
    runner, market, fleet, params = _fresh(wd, _t_events())
    fs, stats = runner.run(params, DUR, TICK)
    return _fingerprint(market, fleet, params, fs, stats), wd


# ------------------------------------------------------------ WAL framing
def _rec(i):
    return {"epoch": np.int64(i), "x": np.arange(i + 1)}


def test_wal_append_read_roundtrip(tmp_path):
    wal = TR.WriteAheadLog(str(tmp_path / "w.wal"))
    for i in range(3):
        wal.append(_rec(i))
    recs, n = wal.read_all()
    assert [int(r["epoch"]) for r in recs] == [0, 1, 2]
    assert n == (tmp_path / "w.wal").stat().st_size


def test_wal_torn_tail_discarded_and_truncated(tmp_path):
    wal = TR.WriteAheadLog(str(tmp_path / "w.wal"))
    wal.append(_rec(0))
    _, clean_len = wal.read_all()
    wal.append(_rec(1), torn_frac=0.5)
    recs, n = wal.read_all()
    assert [int(r["epoch"]) for r in recs] == [0]
    assert n == clean_len
    wal.truncate_to(n)
    wal.append(_rec(2))      # appends after a repaired tail
    recs, _ = wal.read_all()
    assert [int(r["epoch"]) for r in recs] == [0, 2]


def test_wal_corrupt_crc_discarded(tmp_path):
    wal = TR.WriteAheadLog(str(tmp_path / "w.wal"))
    wal.append(_rec(0))
    wal.append(_rec(1))
    data = bytearray((tmp_path / "w.wal").read_bytes())
    data[-1] ^= 0xFF              # flip a byte in the last payload
    (tmp_path / "w.wal").write_bytes(bytes(data))
    recs, _ = wal.read_all()
    assert [int(r["epoch"]) for r in recs] == [0]


# ------------------------------------------------------- checkpointing
def _state(seed):
    """A nested state like the runner's: dicts, a tuple of per-level
    tensors, int32 / float32 / bool leaves and 0-d scalars."""
    g = torch.Generator().manual_seed(seed)
    return {"eng": {"owner": torch.randint(-1, 9, (64,), generator=g,
                                           dtype=torch.int32),
                    "rate": torch.rand(64, generator=g),
                    "floor": (torch.rand(64, generator=g),
                              torch.rand(8, generator=g)),
                    "t": torch.tensor(3.5)},
            "fleet": {"done": torch.rand(8, generator=g) > 0.5},
            "stats": {"orders": torch.tensor(seed, dtype=torch.int32)}}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for step in (10, 20, 30):
        cm.save(step, _state(step), blocking=True)
    assert cm.all_steps() == [20, 30]       # keep=2 gc'd step 10
    _assert_tree_equal(cm.restore(30, _state(0), "cpu"), _state(30))
    with np.load(cm._path(30)) as z:
        assert "['eng']['floor'][1]" in z.files
        assert z["['eng']['t']"].shape == ()
        assert z["['stats']['orders']"].dtype == np.int32


def test_checkpoint_async_save(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, _state(5), blocking=False)
    cm.wait()
    assert cm.latest_step() == 5


def test_checkpoint_no_tmp_litter(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _state(1), blocking=True)
    assert not list(tmp_path.glob(".tmp_*"))


def test_checkpoint_restore_needs_a_device(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _state(1))
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None resolves to the card")
    with pytest.raises(RuntimeError, match="cuda"):
        cm.restore(1, _state(0))


# ---------------------------------------------------- no-crash parity
def test_runner_matches_epoch_runner_and_reference(port_base, tmp_path):
    """The durable runner is the live epoch pipeline: the port's run
    equals the port's ``EpochRunner.drive`` and the reference's
    ``CrashSafeRunner`` bit for bit, the state it publishes passes the
    reference's state contract, and its WAL records and snapshots are
    the reference's (the same keys, dtypes and values, frame by frame
    and leaf by leaf)."""
    base, wd = port_base
    r = _Reference()
    jwd = tmp_path / "ref"
    fs, stats = r.runner(jwd, _j_events()).run(r.params, DUR, TICK)
    _assert_identical(base, r.fingerprint(fs, stats), "port vs reference")
    runner, market, fleet, params = _fresh(tmp_path / "pin", _t_events())
    runner.run(params, DUR, TICK)
    schema.validate_state(to_numpy(market.states["H100"]),
                          r.market.engines["H100"],
                          where="published by CrashSafeRunner.run")
    topo, _, market, fleet, params = TS.make_fleet(
        TS.FleetScenarioConfig(**FCFG), "cpu")
    TS._seed_floors(market, topo)
    fs, _, stats = EpochRunner(market, fleet).drive(
        params, fleet.init_state(params), DUR, TICK,
        injector=T_faults.FaultInjector(_t_events()))
    _assert_identical(base, _fingerprint(market, fleet, params, fs, stats),
                      "runner vs EpochRunner.drive")
    assert base[2]["transfers"] > 0 and base[2]["revoked_by_fault"] > 0
    recs, _ = TR.WriteAheadLog(str(wd / "bids.wal")).read_all()
    jrecs, _ = JR.WriteAheadLog(str(jwd / "bids.wal")).read_all()
    assert len(recs) == len(jrecs) == len(TR._ticks(DUR, TICK))
    for rec, jrec in zip(recs, jrecs):
        assert set(rec) == set(jrec)
        for k in jrec:
            assert rec[k].dtype == jrec[k].dtype, k
            np.testing.assert_array_equal(rec[k], jrec[k], err_msg=k)
    steps = CheckpointManager(str(wd / "snaps")).all_steps()
    assert steps == JCheckpoints(str(jwd / "snaps")).all_steps()
    name = f"ckpt_{steps[-1]:08d}.npz"
    with np.load(wd / "snaps" / name) as a, \
            np.load(jwd / "snaps" / name) as b:
        assert set(a.files) == set(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------- the chaos
def _kill(workdir, crashes):
    runner, _, _, params = _fresh(workdir, _t_events(*crashes))
    with pytest.raises(TR.SimulatedCrash) as exc:
        runner.run(params, DUR, TICK)
    return exc.value.event


_RNG = np.random.default_rng(17)
_TICKS = TR._ticks(DUR, TICK)
CHAOS = [(phase, _TICKS[int(_RNG.integers(1, len(_TICKS)))])
         for phase in TR.PHASES]


@pytest.mark.parametrize("phase,kill_t", CHAOS)
def test_kill_at_phase_then_resume(port_base, tmp_path, phase, kill_t):
    """Killed at one phase boundary of a random epoch, then resumed by a
    fresh process (the fired kill dropped): equal to the uninterrupted
    run (the port's, equal to the reference's)."""
    ev = _kill(tmp_path, [(kill_t, phase)])
    assert ev.phase == phase
    _assert_identical(_resume(tmp_path), port_base[0],
                      f"kill@{kill_t}/{phase}")


def test_first_epoch_kill_before_any_snapshot(port_base, tmp_path):
    """Death at epoch 0 post_wal: no snapshot exists yet, so recovery
    replays the whole run from the facade's initial state."""
    _kill(tmp_path, [(0.0, "post_wal")])
    assert CheckpointManager(str(tmp_path / "snaps")).latest_step() is None
    _assert_identical(_resume(tmp_path), port_base[0], "epoch-0 kill")


def test_double_crash(port_base, tmp_path):
    """Crash, resume, crash again in the resumed run, resume again."""
    _kill(tmp_path, [(180.0, "post_wal"), (420.0, "post_step")])
    runner, _, _, params = _fresh(tmp_path, _t_events((420.0, "post_step")))
    with pytest.raises(TR.SimulatedCrash):
        runner.resume(params, DUR, TICK)
    _assert_identical(_resume(tmp_path), port_base[0], "double crash")


def test_workdirs_cross_implementations(port_base, tmp_path):
    """Workdirs the reference was killed in, at post_wal and at mid_wal
    (a torn frame), resumed by the port; and one the port was killed in,
    resumed by the reference: each ends equal to the uninterrupted
    run."""
    r = _Reference()
    for phase in ("post_wal", "mid_wal"):
        runner = r.runner(tmp_path / phase, _j_events((300.0, phase)))
        with pytest.raises(JR.SimulatedCrash):
            runner.run(r.params, DUR, TICK)
        _assert_identical(_resume(tmp_path / phase), port_base[0],
                          f"reference killed at {phase}, port resumed")
    _kill(tmp_path / "port", [(360.0, "post_step")])
    fs, stats = r.runner(tmp_path / "port", _j_events()).resume(
        r.params, DUR, TICK)
    _assert_identical(r.fingerprint(fs, stats), port_base[0],
                      "port killed, reference resumed")


def test_snapshot_every_five_replays_the_tail(tmp_path):
    """With a snapshot every 5 epochs, a kill at the last epoch's
    post_step resumes from epoch 5's snapshot and replays epochs 6 to 10
    from the WAL, ending equal to the uninterrupted run."""
    runner, _, _, params = _fresh(tmp_path, _t_events((600.0, "post_step")),
                                  snapshot_every=5)
    with pytest.raises(TR.SimulatedCrash):
        runner.run(params, DUR, TICK)
    assert CheckpointManager(str(tmp_path / "snaps")).all_steps() == [0, 5]
    recs, _ = TR.WriteAheadLog(str(tmp_path / "bids.wal")).read_all()
    assert len(recs) == len(_TICKS)
    base_dir = tmp_path / "base"
    r0, m0, f0, p0 = _fresh(base_dir, _t_events(), snapshot_every=5)
    fs, stats = r0.run(p0, DUR, TICK)
    _assert_identical(_resume(tmp_path),
                      _fingerprint(m0, f0, p0, fs, stats), "every 5")
    assert os.path.exists(base_dir / "bids.wal")
