"""Parity of the port's event-driven market path with the JAX reference
on the CPU: the str-tenant ``BatchMarket`` facade
(``repro_torch.market_torch.bridge``) replaying the traces of
``tests/test_differential.py``, the engine's ``clear`` / ``clear_topk``,
``run_once`` for every cloud kind, and the operator's power-aware
floors on the facade.

The traces are made by the port's copy of the event ``Market`` (which
decides what each relinquish event releases).  The reference facade
replays a trace and records a fingerprint after every event: owners,
charged rates, ``settle`` bills, which orders are active (and each
order's ``slot`` / ``seq`` / ``gen``), the stats and the transfer
callbacks fired by the event.  The port's facade must give the same
fingerprint after every event, bit for bit; both must agree with the
event ``Market`` within ``test_differential``'s tolerance.  Each
reference facade compiles its own programs, so every test runs the
reference side it needs itself, once (a module fixture shared by tests
that land on different test workers would be rebuilt on each), and the
compiled programs are dropped when each test ends.  The cold-start
flood places 800 resting bids where ``test_differential`` places
2,000: each facade event is a whole engine step on both sides.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.inframaps import PowerAwareInfraMap as JPowerMap
from repro.core.market import VolatilityControls as JControls
from repro.core.topology import build_cluster as j_build_cluster
from repro.market_jax import schema
from repro.market_jax.bridge import BatchMarket as JBatchMarket
from repro.market_jax.engine import BatchEngine as JEngine
from repro.market_jax.engine import build_tree as j_build_tree
from repro.sim import simulator as S
from repro_torch.convert import to_numpy
from repro_torch.core.inframaps import PowerAwareInfraMap
from repro_torch.core.market import OPERATOR, Market, VolatilityControls
from repro_torch.core.topology import build_cluster
from repro_torch.market_torch.bridge import BatchMarket
from repro_torch.market_torch.engine import NEG, BatchEngine, build_tree
from repro_torch.sim import simulator as TS
from repro_torch.sim.traces import apply_event, market_trace

torch.set_num_threads(1)     # small tensors; leave the cores to XLA

_CTRL = dict(max_bid_multiple=4.0, floor_fall_rate=0.5, min_holding_s=600.0)

# test_differential's traces: (cluster, build_cluster kwargs, controls,
# seed, events, BatchMarket kwargs)
RANDOM_TRACES = {
    "full_tree": ({"H100": 16}, (4, 2, 2), None, 0, 220),
    "partial_tree": ({"H100": 24}, (4, 3, 2), None, 1, 220),
    "two_rtypes": ({"H100": 8, "A100": 8}, (2, 2, 1), None, 2, 220),
    "volatility_controls": ({"H100": 8}, (2, 2, 1), _CTRL, 3, 220),
}
FLOOD_BIDS = 800      # test_differential floods 2,000; see module doc


@pytest.fixture(autouse=True)
def _release_jax_programs():
    """Drop each test's compiled JAX programs when it ends (see
    ``tests/test_torch_fleet.py``): no test here reuses another's."""
    yield
    jax.clear_caches()
    gc.collect()


def _topo(build, counts, shape):
    gph, hpr, rpz = shape
    return build(counts, gpus_per_host=gph, hosts_per_rack=hpr,
                 racks_per_zone=rpz)


def _leaves(topo):
    return [leaf for root in topo.roots.values()
            for leaf in topo.leaves_of(root)]


# ---------------------------------------------------------------- traces
def _random_trace(name):
    """``test_differential.replay``'s trace, made on the port's event
    ``Market``."""
    counts, shape, ctrl, seed, n_events = RANDOM_TRACES[name]
    topo = _topo(build_cluster, counts, shape)
    controls = VolatilityControls(**ctrl) if ctrl else None
    return market_trace(Market(topo, controls), seed, n_events)


def _flood_trace():
    """``test_differential_cold_start_flood``: bids resting under a
    high floor, then one floor drop makes the whole book marketable."""
    topo = _topo(build_cluster, {"H100": 32}, (4, 4, 2))
    root = topo.roots["H100"]
    rng = np.random.default_rng(11)
    tenants = [f"t{i}" for i in range(24)]
    events = [("floor", root, 50.0)]
    for _ in range(FLOOD_BIDS):
        t = tenants[int(rng.integers(len(tenants)))]
        price = float(rng.uniform(1.0, 40.0))
        events.append(("place", t, root, price,
                       price * float(rng.uniform(1.0, 1.5))))
    events += [("floor", root, 2.0), ("advance", 3600.0)]
    return events


def _lap_trace():
    """``test_differential_lap_equal_price_seq_order``: equal-price bids
    placed after the ring allocator lapped the table."""
    topo = _topo(build_cluster, {"H100": 4}, (2, 2, 1))
    root = topo.roots["H100"]
    events = [("floor", root, 100.0)]
    events += [("place", f"bg{i}", root, 2.0, 99.0) for i in range(8)]
    events += [("cancel", "bg5", 5), ("place", "ta", root, 6.0, 99.0),
               ("cancel", "bg2", 2), ("place", "tb", root, 6.0, 99.0),
               ("floor", root, 5.5), ("advance", 1800.0)]
    return events


# spec: (cluster, shape, controls, BatchMarket kwargs, trace maker)
TRACES = {name: (spec[0], spec[1], spec[2],
                 dict(capacity=1 << 10, n_tenants=16),
                 (lambda n=name: _random_trace(n)))
          for name, spec in RANDOM_TRACES.items()}
TRACES["cold_start_flood"] = ({"H100": 32}, (4, 4, 2), None,
                              dict(capacity=1 << 12, n_tenants=64, k=8),
                              _flood_trace)
TRACES["lap_equal_price_seq_order"] = ({"H100": 4}, (2, 2, 1), None,
                                       dict(capacity=8, n_tenants=16),
                                       _lap_trace)


class _Recorder:
    """Fingerprints a facade after each event: owners, rates and bills
    per leaf and tenant, which orders are active, the stats and the
    callbacks fired since the last event.  Each order's (tenant, scope,
    rtype, slot, seq, gen) is fixed when it is placed and is kept once
    (``static``)."""

    def __init__(self, bm, topo):
        self.bm = bm
        self.leaves = _leaves(topo)
        self.calls = []
        bm.on_transfer.append(lambda *a: self.calls.append(a))
        self.static = []
        self.cols = {rtype: ([], [], [], []) for rtype in bm.engines}

    def _active(self):
        bm = self.bm
        for oid in range(len(self.static), len(bm.orders)):
            o = bm.orders[oid]
            self.static.append((o.tenant, o.scope, o.rtype, o.slot, o.seq,
                                o.gen))
            for col, v in zip(self.cols[o.rtype],
                              (oid, o.slot, o.gen, bm._tenants[o.tenant])):
                col.append(v)
        active = np.zeros(len(self.static), bool)
        for rtype, cols in self.cols.items():
            if not cols[0]:
                continue
            idx, slot, gen, tid = (np.asarray(c) for c in cols)
            host = bm._host(rtype)
            active[idx] = (bm._slot_gen[rtype][slot] == gen) \
                & (host["tenant"][slot] == tid) \
                & (host["price"][slot] > NEG / 2)
        return active

    def take(self):
        bm = self.bm
        fp = {"owner": [bm.owner_of(leaf) for leaf in self.leaves],
              "rate": np.array([bm.market_rate(leaf)
                                for leaf in self.leaves], np.float32),
              "bills": bm.settle(),
              "stats": dict(bm.stats), "calls": self.calls,
              "active": self._active()}
        self.calls = []
        return fp


def _replay(make_market, build, name):
    counts, shape, ctrl, kw, trace = TRACES[name]
    topo = _topo(build, counts, shape)
    bm = make_market(topo, ctrl, kw)
    rec = _Recorder(bm, topo)
    fps = []
    for e in trace():
        apply_event(bm, e)
        fps.append(rec.take())
    fps[-1]["orders"] = rec.static
    return fps, bm, topo


def _ref_market(topo, ctrl, kw):
    return JBatchMarket(topo, JControls(**ctrl) if ctrl else None, **kw)


def _port_market(topo, ctrl, kw):
    return BatchMarket(topo, VolatilityControls(**ctrl) if ctrl else None,
                       device="cpu", **kw)


def _assert_fp_equal(ref, got, where):
    assert got["owner"] == ref["owner"], where
    np.testing.assert_array_equal(got["rate"], ref["rate"], err_msg=where)
    assert got["bills"] == ref["bills"], where
    assert got["stats"] == ref["stats"], where
    assert got["calls"] == ref["calls"], where
    np.testing.assert_array_equal(got["active"], ref["active"],
                                  err_msg=where)
    assert got.get("orders") == ref.get("orders"), where


@pytest.mark.parametrize("name", list(TRACES))
def test_facade_trace_matches_reference(name):
    """After every event of the trace the port's facade equals the
    reference facade bit for bit, and the event ``Market`` within
    ``test_differential``'s tolerance; its final states keep the
    reference's state contract (keys, dtypes, shapes)."""
    trace = TRACES[name][4]()
    refs, ref_bm, _ = _replay(_ref_market, j_build_cluster, name)
    fps, bm, _ = _replay(_port_market, build_cluster, name)
    assert len(fps) == len(refs) == len(trace)
    counts, shape, ctrl = TRACES[name][:3]
    topo = _topo(build_cluster, counts, shape)
    ev = Market(topo, VolatilityControls(**ctrl) if ctrl else None)
    tenants = sorted({e[1] for e in trace if e[0] == "place"})
    for i, (e, ref, got) in enumerate(zip(trace, refs, fps)):
        where = f"{name} event {i} {e}"
        _assert_fp_equal(ref, got, where)
        apply_event(ev, e)
        assert [ev.owner_of(leaf) for leaf in _leaves(topo)] \
            == got["owner"], where
        ev_rates = [ev.market_rate(leaf) for leaf in _leaves(topo)]
        np.testing.assert_allclose(got["rate"], ev_rates, atol=1e-4,
                                   rtol=0, err_msg=where)
        eb = ev.settle()
        for t in tenants:
            assert eb.get(t, 0.0) == pytest.approx(
                got["bills"].get(t, 0.0), rel=1e-4, abs=1e-3), (where, t)
    assert bm.stats["transfers"] > 0
    for rtype, st in bm.states.items():
        assert not schema.check_state(
            to_numpy(st), ref_bm.engines[rtype],
            where=f"{name} {rtype}")


def test_lap_trace_keeps_arrival_order():
    """The lap trace's two 6.0 bids: A lands in the higher slot but
    arrived first, and takes the first leaf."""
    fps, bm, _ = _replay(_port_market, build_cluster,
                         "lap_equal_price_seq_order")
    a, b = bm.orders[8], bm.orders[9]
    assert (a.tenant, b.tenant) == ("ta", "tb")
    assert a.slot > b.slot and a.seq < b.seq
    assert fps[-1]["owner"][:2] == ["ta", "tb"]
    assert all(o == OPERATOR or o.startswith("t")
               for o in fps[-1]["owner"])


def test_place_order_raises_when_table_full():
    topo = _topo(build_cluster, {"H100": 4}, (2, 2, 1))
    bm = BatchMarket(topo, capacity=4, n_tenants=8, device="cpu")
    root = topo.roots["H100"]
    bm.set_floor(root, 100.0)
    for i in range(4):
        bm.place_order(f"t{i}", root, 1.0)
    with pytest.raises(RuntimeError, match="bid table full"):
        bm.place_order("t5", root, 1.0)


def test_set_retention_limit_does_not_alias_held_state():
    """The limit write is out of place: a state a caller still holds
    keeps its old limits."""
    topo = _topo(build_cluster, {"H100": 4}, (2, 2, 1))
    bm = BatchMarket(topo, capacity=16, n_tenants=8, device="cpu")
    root = topo.roots["H100"]
    bm.set_floor(root, 1.0)
    bm.place_order("a", root, 3.0, limit=5.0)
    leaf = next(iter(bm.owned_leaves("a")))
    held = bm.states["H100"]
    before = held["limit"].clone()
    bm.set_retention_limit("a", leaf, 7.0)
    assert torch.equal(held["limit"], before)
    _, i = bm._leaf_local[leaf]
    assert float(bm.states["H100"]["limit"][i]) == 7.0


# ------------------------------------------------------- clear / topk
def _books():
    """Two books (k 4 at 64 leaves, k 8 at 256 leaves with floors and
    owners) as numpy state, made by the port's engine on the CPU."""
    out = []
    for n_leaves, k, seed in ((64, 4, 0), (256, 8, 1)):
        rng = np.random.default_rng(seed)
        eng = BatchEngine(build_tree(n_leaves), capacity=512, n_tenants=12,
                          k=k, device="cpu")
        st = eng.init_state()
        tree = eng.tree
        b = 300
        levels = rng.integers(0, tree.n_levels, b).astype(np.int32)
        nodes = np.array([rng.integers(0, tree.nodes_at(d))
                          for d in levels], np.int32)
        prices = rng.uniform(0.5, 9.0, b).astype(np.float32)
        prices[::4] = np.round(prices[::4])
        tenants = rng.integers(0, 12, b).astype(np.int32)
        st = eng.place(st, *(torch.from_numpy(a) for a in
                             (prices, levels, nodes, tenants)))
        st["floor"] = tuple(
            torch.from_numpy(rng.uniform(0, 3, tree.nodes_at(d))
                             .astype(np.float32))
            for d in range(tree.n_levels))
        owned = rng.random(n_leaves) < 0.6
        st["owner"] = torch.from_numpy(np.where(
            owned, rng.integers(0, 12, n_leaves), -1).astype(np.int32))
        st["limit"] = torch.from_numpy(np.where(
            owned, rng.uniform(2, 8, n_leaves), np.inf).astype(np.float32))
        st["health"] = torch.from_numpy(
            rng.choice([0, 0, 0, 1, 2], n_leaves).astype(np.int32))
        out.append((n_leaves, k, st))
    return out


@pytest.mark.parametrize("book", [0, 1])
def test_clear_and_topk_match_reference(book):
    n_leaves, k, st = _books()[book]
    teng = BatchEngine(build_tree(n_leaves), capacity=512, n_tenants=12,
                       k=k, device="cpu")
    jeng = JEngine(j_build_tree(n_leaves), capacity=512, n_tenants=12, k=k)
    jst = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.numpy()), st)
    jst["floor"] = tuple(jst["floor"])
    jst["floor_t"] = tuple(jst["floor_t"])
    for name, tf, jf in (("clear", teng.clear, jeng.clear),
                         ("clear_topk", teng.clear_topk, jeng.clear_topk)):
        got = tf(st)
        want = jf(jst)
        assert len(got) == len(want)
        for j, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            assert g.dtype == torch.from_numpy(np.array(w)).dtype, (name, j)
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{name}[{j}]")
    winner = teng.clear(st)[2]
    assert (winner >= 0).any() and (winner < 0).any()


# ------------------------------------------------------------ run_once
# tests/test_sim.py's laissez_batch scenario
SIM_SMALL = dict(regime="slight", n_h100=4, n_a100=4, duration_s=900.0,
                 tick_s=90.0, n_training=1, n_inference=1, n_batch=0,
                 seed=3)


@pytest.mark.parametrize("kind", ["fcfs", "fcfsp", "spot", "laissez",
                                  "laissez_batch"])
def test_run_once_matches_reference(kind):
    ref = S.run_once(kind, S.ScenarioConfig(**SIM_SMALL))
    got = TS.run_once(kind, TS.ScenarioConfig(**SIM_SMALL), device="cpu")
    assert got.perf == ref.perf
    assert got.cost == ref.cost
    assert got.stats == ref.stats
    assert len(got.perf) == 2


def test_event_path_device_none_means_cuda():
    """The event path's entry points default to CUDA and raise without
    it; ``laissez_batch`` asks for a device too."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None resolves to the card")
    topo = _topo(build_cluster, {"H100": 4}, (2, 2, 1))
    with pytest.raises(RuntimeError, match="cuda"):
        BatchMarket(topo)
    with pytest.raises(RuntimeError, match="cuda"):
        TS.run_once("laissez_batch", TS.ScenarioConfig(**SIM_SMALL))
    with pytest.raises(ValueError, match="unknown cloud kind"):
        TS.run_once("fifo", TS.ScenarioConfig(**SIM_SMALL), device="cpu")


# ------------------------------------------------------------ InfraMaps
def _power_drive(topo, bm, power_map_cls):
    """Power-aware floors on every rack (paper Fig 11) over four
    readings, with three tenants bidding; returns the floors, owners,
    rates and bills after each reading."""
    root = topo.roots["H100"]
    bm.set_floor(root, 2.0)
    racks = [r for z in topo.node(root).children
             for r in topo.node(z).children]
    pm = power_map_cls(bm, {r: topo.leaves_of(r) for r in racks},
                       power_cap=10.0)
    for i, t in enumerate(("a", "b", "c")):
        bm.place_order(t, root, 3.0 + i, limit=6.0 + i)
    out = []
    t0 = bm.now
    for step, used in enumerate((6.0, 9.5, 12.0, 7.0)):
        bm.advance_to(t0 + 600.0 * (step + 1))
        pm.observe(bm.now, {r: used + 0.5 * j for j, r in enumerate(racks)})
        leaves = topo.leaves_of(root)
        out.append((dict(pm.floors), [bm.floor(leaf) for leaf in leaves],
                    [bm.owner_of(leaf) for leaf in leaves],
                    [bm.market_rate(leaf) for leaf in leaves], bm.settle()))
    return out


def test_power_aware_floors_match_reference():
    """The operator's power-aware floors on the port's facade equal the
    reference's: floors, owners, rates and bills after every reading."""
    shape = ({"H100": 16}, (4, 2, 2))
    jtopo = _topo(j_build_cluster, *shape)
    ttopo = _topo(build_cluster, *shape)
    ref = _power_drive(jtopo, JBatchMarket(jtopo, capacity=64, n_tenants=8),
                       JPowerMap)
    got = _power_drive(ttopo, BatchMarket(ttopo, capacity=64, n_tenants=8,
                                          device="cpu"), PowerAwareInfraMap)
    assert got == ref
    assert got[2][0] != got[0][0]          # the floors moved
