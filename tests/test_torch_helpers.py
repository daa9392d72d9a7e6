"""Bit-for-bit parity of the port's small helpers with the reference on
the CPU: the topology queries (``covers``, ``n_leaves``,
``common_scope``, ``depth``), the Fig 11 and arrival traces
(``power_rows``, ``poisson_arrivals``), the one-shot segment aggregates
(``segment_aggregates``, ``segment_top2``,
``sorted_segment_aggregates``) on the inputs of
``tests/test_kernels.py``, and Fig 11's power-steering scenario through
the port's ``Market``, ``PowerAwareInfraMap``, ``EconAdapter`` and
``Tenant``.
"""
import gc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as JT
from repro.kernels.market_clear import ref as JR
from repro.sim import traces as J_traces
from repro_torch.core import topology as TT
from repro_torch.kernels.market_clear import ref as TR
from repro_torch.sim import traces as T_traces

NEG = -1e30
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _release_jax_programs():
    """Drop each test's compiled JAX programs when it ends (see
    ``tests/test_torch_fleet.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


# -------------------------------------------------------------- topology
CLUSTERS = [({"H100": 8}, dict(gpus_per_host=4, hosts_per_rack=1,
                               racks_per_zone=1)),
            ({"H100": 37, "A100": 11}, {}),
            ({"H100": 300}, dict(gpus_per_host=8, hosts_per_rack=4,
                                 racks_per_zone=4))]


@pytest.mark.parametrize("counts,kw", CLUSTERS,
                         ids=["fig11", "two_types", "three_zones"])
def test_topology_helpers_match_reference(counts, kw):
    j, t = JT.build_cluster(counts, **kw), TT.build_cluster(counts, **kw)
    assert t.n_leaves() == j.n_leaves() and t.depth() == j.depth()
    n = len(j.nodes)
    assert len(t.nodes) == n
    leaves = [nid for nid in range(n) if j.node(nid).is_leaf]
    rng = np.random.default_rng(len(leaves))
    for scope in range(n):
        for leaf in leaves:
            assert t.covers(scope, leaf) == j.covers(scope, leaf)
    for a, b in rng.integers(0, n, (400, 2)):
        a, b = int(a), int(b)
        try:
            want = j.common_scope(a, b)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                t.common_scope(a, b)
            continue
        assert t.common_scope(a, b) == want


def test_empty_topology_depth():
    assert TT.Topology().freeze().depth() == JT.Topology().freeze().depth()


# ---------------------------------------------------------------- traces
@pytest.mark.parametrize("seed,duration,cap,tick", [
    (1, 3600.0, 100.0, 10.0), (7, 900.0, 40.0, 10.0),
    (3, 250.0, 100.0, 30.0), (11, 7200.0, 100.0, 60.0)])
def test_power_rows_match_reference(seed, duration, cap, tick):
    j = J_traces.power_rows(seed, duration, cap_kw=cap, tick_s=tick)
    t = T_traces.power_rows(seed, duration, cap_kw=cap, tick_s=tick)
    assert t.keys() == j.keys()
    times = list(np.arange(0.0, duration + 3 * tick, tick / 2)) \
        + [299.9, 300.0, 1e9]
    for row in j:
        got = [t[row](now) for now in times]
        assert got == [j[row](now) for now in times]
        assert all(type(v) is float for v in got)


@pytest.mark.parametrize("seed,duration,gap", [
    (0, 3600.0, 60.0), (5, 900.0, 7.5), (9, 10.0, 100.0), (2, 86400.0,
                                                            300.0)])
def test_poisson_arrivals_match_reference(seed, duration, gap):
    got = T_traces.poisson_arrivals(seed, duration, gap)
    assert got == J_traces.poisson_arrivals(seed, duration, gap)
    assert all(0.0 < x < duration for x in got)


# ---------------------------------------------------- segment aggregates
def _both(fn_name, *args, **kw):
    """The reference's and the port's ``fn_name`` on the same numpy
    inputs, each output as numpy."""
    def j(a):
        return jnp.asarray(a) if isinstance(a, np.ndarray) else a

    def t(a):
        return torch.from_numpy(np.array(a)) \
            if isinstance(a, np.ndarray) else a
    jargs, targs = [j(a) for a in args], [t(a) for a in args]
    jkw = {k: j(v) for k, v in kw.items()}
    tkw = {k: t(v) for k, v in kw.items()}
    want = getattr(JR, fn_name)(*jargs, **jkw)
    got = getattr(TR, fn_name)(*targs, **tkw)
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


def _assert_bitwise(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.dtype == g.dtype and w.shape == g.shape, i
        np.testing.assert_array_equal(
            np.ascontiguousarray(w).view(np.uint8),
            np.ascontiguousarray(g).view(np.uint8), err_msg=f"output {i}")


def _f32(x):
    return np.asarray(x, np.float32)


def _i32(x):
    return np.asarray(x, np.int32)


# tests/test_kernels.py's inputs: (prices, seg, tenants, n_seg, k, seqs)
SEGMENT_CASES = {
    "top2": (_f32([5.0, 3.0, 7.0, NEG, 2.0, 7.0]), _i32([0, 0, 1, 1, 0, 1]),
             _i32([10, 11, 12, 13, 14, 15]), 3, 1, None),
    "owner_exclusion": (_f32([9.0, 8.0, 5.0, 1.0]), _i32([0, 0, 0, 0]),
                        _i32([7, 7, 3, 2]), 1, 1, None),
    "ranked_topk": (_f32([5.0, 9.0, 7.0, 9.0, NEG, 3.0]),
                    _i32([0, 0, 0, 0, 0, 1]), _i32([1, 2, 1, 3, 4, 2]), 2, 4,
                    None),
    "seq_ties": (_f32([6.0, 6.0, 6.0, 2.0]), _i32([0, 0, 0, 0]),
                 _i32([1, 2, 3, 4]), 1, 3, _i32([30, 10, 5, 0])),
}


def _random_segment_case(seed):
    rng = np.random.default_rng(seed)
    nb, n_seg = 300, 17
    prices = np.round(rng.uniform(0.5, 9.0, nb), 1).astype(np.float32)
    tenants = rng.integers(-1, 9, nb).astype(np.int32)
    prices[rng.random(nb) < 0.2] = NEG
    prices[rng.random(nb) < 0.05] = -0.0
    seg = rng.integers(-2, n_seg + 2, nb).astype(np.int32)
    seqs = rng.permutation(nb).astype(np.int32)
    return prices, seg, tenants, n_seg, 5, seqs


SEGMENT_CASES.update({f"random_{s}": _random_segment_case(s)
                      for s in (0, 1)})


@pytest.mark.parametrize("name", sorted(SEGMENT_CASES))
def test_segment_aggregates_match_reference(name):
    prices, seg, tenants, n_seg, k, seqs = SEGMENT_CASES[name]
    kw = {} if seqs is None else {"seqs": seqs}
    want, got = _both("segment_aggregates", prices, seg, tenants, n_seg,
                      k=k, **kw)
    _assert_bitwise(want, got)
    want, got = _both("segment_top2", prices, seg, tenants, n_seg)
    _assert_bitwise(want, got)


def test_segment_aggregates_reference_assertions():
    """``tests/test_kernels.py``'s own expectations, on the port."""
    p, s, t, n, _, _ = SEGMENT_CASES["top2"]
    t1, o1, t2 = TR.segment_top2(torch.from_numpy(p), torch.from_numpy(s),
                                 torch.from_numpy(t), n)
    assert float(t1[0]) == 5.0 and float(t2[0]) == 3.0
    assert float(t1[1]) == 7.0 and float(t2[1]) == 7.0
    assert int(o1[0]) == 10
    p, s, t, n, k, q = SEGMENT_CASES["seq_ties"]
    pk, tk, sk, qk, p2, s2, q2 = TR.segment_aggregates(
        torch.from_numpy(p), torch.from_numpy(s), torch.from_numpy(t), n,
        k=k, seqs=torch.from_numpy(q))
    assert sk[:, 0].tolist() == [2, 1, 0] and qk[:, 0].tolist() == [5, 10, 30]
    assert float(p2[0]) == 6.0 and int(s2[0]) == 1 and int(q2[0]) == 10


@pytest.mark.parametrize("stale", [False, True])
def test_sorted_segment_aggregates_match_reference(stale):
    """``test_sorted_segment_aggregates_skips_killed_entries``'s book:
    the view sorted once, then (``stale``) its top entry killed."""
    prices = _f32([9.0, 7.0, 5.0, 8.0, 3.0])
    seg = _i32([0, 0, 0, 1, 1])
    tenants = _i32([1, 2, 3, 1, 2])
    seqs = np.arange(5, dtype=np.int32)
    order, sorted_gseg = JR.sort_book(jnp.asarray(seg), jnp.asarray(prices),
                                      jnp.asarray(seqs))
    seg_start = np.asarray(jnp.searchsorted(
        sorted_gseg, jnp.arange(3, dtype=jnp.int32)).astype(jnp.int32))
    t_order, t_sg = TR.sort_book(torch.from_numpy(seg),
                                 torch.from_numpy(prices),
                                 torch.from_numpy(seqs))
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(order))
    np.testing.assert_array_equal(t_sg.numpy(), np.asarray(sorted_gseg))
    if stale:
        prices = prices.copy()
        tenants = tenants.copy()
        prices[0], tenants[0] = NEG, -1
    for k in (1, 2, 4):
        want, got = _both("sorted_segment_aggregates", np.asarray(order),
                          np.asarray(sorted_gseg), seg_start, prices,
                          tenants, seqs, 2, k)
        _assert_bitwise(want, got)
    if stale:
        assert got[0][:2, 0].tolist() == [7.0, 5.0]


# ----------------------------------------------------------------- Fig 11
def _fig11_port():
    """``benchmarks/fig11_power_steering.py`` ``run()`` through the
    port's modules: row A's load and floor price at each of 60 steps."""
    from repro_torch.core.econadapter import AdapterConfig, EconAdapter
    from repro_torch.core.inframaps import InfraMapConfig, \
        PowerAwareInfraMap
    from repro_torch.core.market import Market
    from repro_torch.sim.workloads import Tenant, WorkloadParams
    topo = TT.build_cluster({"H100": 8}, gpus_per_host=4, hosts_per_rack=1,
                            racks_per_zone=1)
    root = topo.roots["H100"]
    rowA, rowB = topo.node(root).children[:2]
    m = Market(topo)
    m.set_floor(root, 2.0)
    imap = PowerAwareInfraMap(m, {rowA: [rowA], rowB: [rowB]},
                              power_cap=100.0, target_util=0.8,
                              cfg=InfraMapConfig(base_price=2.0,
                                                 power_coeff=8.0))
    rows = T_traces.power_rows(1, 3600.0)
    tenants = []
    for i in range(3):
        t = Tenant(f"t{i}", WorkloadParams(
            kind="training", work=3.0, deadline_s=3600.0,
            checkpoint_interval_s=120.0, reconfig_s=60.0, max_nodes=2,
            topology_sensitive=False, value_per_gap=25.0), topo)
        t.attach(m)
        tenants.append((t, EconAdapter(m, t.name, t, AdapterConfig())))
    loadA, priceA = [], []
    for step in range(60):
        now = step * 60.0
        imap.observe(now, {rowA: rows["rowA"](now),
                           rowB: rows["rowB"](now)})
        for t, ad in tenants:
            ad.step(now)
            t.advance(now)
        loadA.append(sum(1 for t, _ in tenants
                         for leaf in m.owned_leaves(t.name)
                         if topo.covers(rowA, leaf)))
        priceA.append(imap.floors.get(rowA, 2.0))
    return loadA, priceA


def test_fig11_scenario_matches_reference():
    from benchmarks.fig11_power_steering import run
    want_load, want_price = run()
    load, price = _fig11_port()
    assert len(load) == 60
    assert load == want_load and price == want_price
    # the figure's claim: load leaves the constrained row, its price rises
    assert sum(load[-10:]) / 10 < sum(load[2:5]) / 3
    assert price[-1] > 2.0 and math.isfinite(price[-1])
