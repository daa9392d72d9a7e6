"""The port's CUDA side: the market-clearing kernel against its plain
version on the card, the whole fleet slice on the card against the CPU
run, and the wrapper and build checks that hold without a card.

No JAX here, so the file also runs on a machine that has only PyTorch
(``pytest -m cuda tests/test_torch_cuda.py`` on the card).  Tests that
need the card carry the ``cuda`` marker and skip without CUDA.
"""
import shutil
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.convert import to_numpy
from repro_torch.kernels import build
from repro_torch.kernels.market_clear import kernel as K
from repro_torch.kernels.market_clear import ops
from repro_torch.kernels.market_clear import ref as R
from repro_torch.kernels.ssd_scan.ref import sample_inputs
from repro_torch.market_torch.engine import BatchEngine, TreeSpec, \
    build_tree

NAMES = ("rate", "best_level", "cand_slots", "truncated", "evict")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")


def _book(tree, k, seed, dev, n_bids=700, n_ten=9):
    rng = np.random.default_rng(seed)
    eng = BatchEngine(tree, capacity=4096, k=k, device=dev)
    st = eng.init_state()
    st["floor"][-1] = torch.tensor([1.5], device=dev)
    levels = rng.integers(0, tree.n_levels, n_bids).astype(np.int32)
    nodes = np.array([rng.integers(0, tree.nodes_at(d)) for d in levels],
                     np.int32)
    prices = rng.uniform(1, 9, n_bids).astype(np.float32)
    prices[::3] = np.round(prices[::3])
    tenants = rng.integers(0, n_ten, n_bids).astype(np.int32)
    st = eng.place(st, *(torch.from_numpy(a).to(dev)
                         for a in (prices, levels, nodes, tenants)))
    owned = rng.random(tree.n_leaves) < 0.7
    st["owner"] = torch.from_numpy(np.where(
        owned, rng.integers(0, n_ten, tree.n_leaves), -1)
        .astype(np.int32)).to(dev)
    st["limit"] = torch.from_numpy(np.where(
        owned, rng.uniform(2, 8, tree.n_leaves), np.inf)
        .astype(np.float32)).to(dev)
    return eng, st


def _aggs(eng, st):
    n_seg = st["seg_start"].shape[0] - 1
    return R._prefix_aggregates(st["order"], st["sorted_gseg"],
                                st["seg_start"], st["price"], st["tenant"],
                                st["seq"], n_seg, eng.k)


def test_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never runs the plain version: CPU tensors are
    an error, not a fallback."""
    eng, st = _book(build_tree(64), 4, 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        K.clear_cuda(*_aggs(eng, st), tuple(st["floor"]), eng.level_off,
                     eng.tree.strides, st["owner"], st["limit"])


def test_ops_rejects_other_devices():
    eng, st = _book(build_tree(64), 4, 0, "cpu")
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else
                [f.to("meta") for f in v]) for k, v in st.items()}
    with pytest.raises(ValueError, match="device"):
        ops.clear(meta["order"], meta["sorted_gseg"], meta["seg_start"],
                  meta["price"], meta["tenant"], meta["seq"],
                  tuple(meta["floor"]), eng.level_off, eng.tree.strides,
                  meta["owner"], meta["limit"], eng.k)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc means an error naming it, never a silent plain path."""
    if shutil.which("nvcc") or pathlib.Path(
            "/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build("market_clear")


def test_library_name_follows_source_hash():
    path = build.library_path("market_clear")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("market_clear-") and path.suffix == ".so"


def _lap_book(dev):
    """Equal-price root bids in slots reused after a ring lap, so slot
    order inverts seq order (the reference's lap-reused seq ties)."""
    tree = build_tree(64)
    eng = BatchEngine(tree, capacity=8, k=4, device=dev)
    st = eng.init_state()
    root = tree.n_levels - 1

    def bids(tenants):
        m = len(tenants)
        return (torch.full((m,), 5.0, device=dev),
                torch.full((m,), root, dtype=torch.int32, device=dev),
                torch.zeros((m,), dtype=torch.int32, device=dev),
                torch.tensor(tenants, dtype=torch.int32, device=dev))
    st = eng.place(st, *bids(list(range(8))))
    for slot, ten in ((5, 8), (2, 9)):
        st = eng.cancel(st, torch.tensor([slot], dtype=torch.int32,
                                         device=dev))
        st = eng.place(st, *bids([ten]))
    return eng, st


def _truncated_book(dev):
    """A host-level book deeper than k: truncated slates."""
    tree = build_tree(512)
    eng = BatchEngine(tree, capacity=4096, k=2, device=dev)
    st = eng.init_state()
    rng = np.random.default_rng(5)
    m = 40
    st = eng.place(st, torch.from_numpy(
        rng.uniform(3, 9, m).astype(np.float32)).to(dev),
        torch.ones(m, dtype=torch.int32, device=dev),
        torch.zeros(m, dtype=torch.int32, device=dev),
        torch.arange(m, dtype=torch.int32, device=dev))
    return eng, st


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [("n1024", 1), ("n1024", 8),
                                     ("n10000", 16), ("n24", 4),
                                     ("n10000", 32), ("n768", 8),
                                     ("lap", 4), ("trunc", 2)])
def test_kernel_matches_plain_on_card(shape, k):
    _need_cuda()
    if shape == "lap":
        eng, st = _lap_book("cuda")
    elif shape == "trunc":
        eng, st = _truncated_book("cuda")
    else:
        tree = TreeSpec(24, (1, 4, 12, 24)) if shape == "n24" \
            else build_tree(int(shape[1:]))
        eng, st = _book(tree, k, 41 + k, "cuda",
                        n_bids=8192 if shape == "n10000" else 700)
    assert eng.k == k
    aggs = _aggs(eng, st)
    args = (tuple(st["floor"]), eng.level_off, eng.tree.strides,
            st["owner"], st["limit"])
    before = K.LAUNCHES
    got = K.clear_cuda(*aggs, *args)
    plain = R.clear_sorted_from_aggs(aggs, *args, k)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    for name, a, b in zip(NAMES, plain, got):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_kernel_in_cuda_graph_matches_eager():
    """Captured in a CUDA graph and replayed, the kernel writes the same
    five outputs as an eager call (its level table is built on the
    first, eager call)."""
    _need_cuda()
    eng, st = _book(build_tree(10000), 16, 57, "cuda", n_bids=8192)
    aggs = _aggs(eng, st)
    args = (tuple(st["floor"]), eng.level_off, eng.tree.strides,
            st["owner"], st["limit"])
    eager = K.clear_cuda(*aggs, *args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = K.clear_cuda(*aggs, *args)
    for x in replayed:
        x.fill_(-7)
    graph.replay()
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, eager, replayed):
        assert torch.equal(a, b), name
    assert (replayed[2] >= -1).all()


def _hazard_aggs(tree, k, seed, dev):
    """Aggregates no engine makes, for every segment: few prices and
    seqs (equal (price, seq) keys, equal prices), ±0.0, unsorted lists,
    dead entries with stray payloads, a NaN price in some lists, random
    fall-backs; every level has a live head, so the plain version merges
    every node."""
    rng = np.random.default_rng(seed)
    n_seg = sum(tree.nodes_at(d) for d in range(tree.n_levels))
    p = rng.choice(np.float32([4, 3, 2, 1, 0, -0.0, -1e30]), (n_seg, k))
    p[rng.random((n_seg, k)) < 0.5] = -1e30
    p[rng.random(n_seg) < 0.02, 0] = np.nan
    p[:, 0] = np.where(rng.random(n_seg) < 0.1, np.float32(5), p[:, 0])
    off = 0
    for d in range(tree.n_levels):
        p[off, 0] = 6.0
        off += tree.nodes_at(d)
    t = rng.integers(-1, 6, (n_seg, k))
    s = rng.integers(-1, 99, (n_seg, k))
    q = rng.integers(0, 5, (n_seg, k))
    p2 = rng.choice(np.float32([2.5, 1.5, -1e30]), n_seg)
    t2, s2, q2 = (rng.integers(-1, 6, n_seg), rng.integers(-1, 99, n_seg),
                  rng.integers(0, 5, n_seg))
    i32 = np.int32
    return tuple(torch.from_numpy(x.astype(t_)).to(dev) for x, t_ in (
        (p, np.float32), (t, i32), (s, i32), (q, i32), (p2, np.float32),
        (t2, i32), (s2, i32), (q2, i32)))


DEEP = TreeSpec(64, (1, 1, 2, 4, 64))   # k 32: a 95 KB plan, opted into


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [("n768", 8), ("n24", 4),
                                     ("n10000", 16), ("n768", 32),
                                     ("deep", 32)])
def test_kernel_matches_plain_on_hazard_lists_on_card(shape, k):
    """NaN prices, equal keys, ±0.0 and unsorted or stray lists: the
    kernel's merges (and the merges it proves to be the identity and
    skips) equal the plain version's; the deep tree's plan needs more
    than 48 KB of shared memory a block."""
    _need_cuda()
    tree = {"n24": TreeSpec(24, (1, 4, 12, 24)), "deep": DEEP}.get(shape) \
        or build_tree(int(shape[1:]))
    aggs = _hazard_aggs(tree, k, 70 + k, "cuda")
    rng = np.random.default_rng(k)
    level_off, acc, floors = [], 0, []
    for d in range(tree.n_levels):
        level_off.append(acc)
        acc += tree.nodes_at(d)
        floors.append(torch.from_numpy(rng.choice(
            np.float32([0, 0.5, 2]), tree.nodes_at(d))).cuda())
    n = tree.n_leaves
    owner = torch.from_numpy(rng.integers(-1, 6, n).astype(np.int32)).cuda()
    limit = torch.from_numpy(rng.uniform(1, 6, n).astype(np.float32)).cuda()
    args = (tuple(floors), tuple(level_off), tree.strides, owner, limit)
    got = K.clear_cuda(*aggs, *args)
    plain = R.clear_sorted_from_aggs(aggs, *args, k)
    torch.cuda.synchronize()
    assert torch.allclose(got[0], plain[0], rtol=0, atol=0, equal_nan=True)
    for name, a, b in zip(NAMES[1:], plain[1:], got[1:]):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_fleet_slice_on_card_matches_cpu():
    """The whole slice at a small size: identical on the card (kernel)
    and on the CPU (plain version), and the kernel ran once per wave."""
    _need_cuda()
    from repro_torch.sim.simulator import FleetScenarioConfig, \
        run_fleet_scenario
    cfg = FleetScenarioConfig(
        regime="heavy", n_leaves=256, n_training=6, n_inference=6,
        n_batch=4, duration_s=600.0, tick_s=60.0, seed=3, k=8, b_max=128,
        per_tenant_bids=4, alone="analytic")
    K.LAUNCHES = 0
    gpu = run_fleet_scenario(cfg, device="cuda")
    assert K.LAUNCHES == int(gpu.engine_state["waves"]) > 0
    cpu = run_fleet_scenario(cfg, device="cpu")
    eg, ec = to_numpy(gpu.engine_state), to_numpy(cpu.engine_state)
    for key in ec:
        pairs = zip(ec[key], eg[key]) if key in ("floor", "floor_t") \
            else [(ec[key], eg[key])]
        for a, b in pairs:
            np.testing.assert_array_equal(a, b, err_msg=key)
    np.testing.assert_array_equal(gpu.perf, cpu.perf)
    assert gpu.stats == cpu.stats


@pytest.mark.cuda
def test_kernel_matches_plain_on_health_masked_book_on_card():
    """A 256-leaf book whose leaves are up, DOWN and DRAINING (a rack
    down, a host draining, scattered leaves of both): the kernel's five
    outputs equal the plain version's, before and after the health
    mask."""
    _need_cuda()
    from repro_torch.sim.faults import FaultEvent, FaultInjector
    eng, st = _book(build_tree(256), 8, 23, "cuda")
    events = [FaultEvent(0.0, "fail", 2, 1), FaultEvent(0.0, "drain", 1, 0)]
    rng = np.random.default_rng(4)
    events += [FaultEvent(0.0, str(kind), 0, int(leaf)) for kind, leaf in
               zip(rng.choice(["fail", "drain"], 40),
                   rng.choice(256, 40, replace=False))]
    st = FaultInjector(events).apply_health(eng, st, 0.0)
    health = st["health"]
    assert (health == R.HEALTH_DOWN).sum() > 32
    assert (health == R.HEALTH_DRAINING).sum() > 8
    aggs = _aggs(eng, st)
    args = (tuple(st["floor"]), eng.level_off, eng.tree.strides,
            st["owner"], st["limit"])
    got = K.clear_cuda(*aggs, *args)
    plain = R.clear_sorted_from_aggs(aggs, *args, eng.k)
    torch.cuda.synchronize()
    mask = (args[0], args[2], args[3], args[4])
    for name, a, b in zip(NAMES, plain, got):
        assert torch.equal(a, b), name
    for name, a, b in zip(NAMES, R.apply_health_mask(health, *plain, *mask),
                          R.apply_health_mask(health, *got, *mask)):
        assert torch.equal(a, b), name
    masked = ops.clear(st["order"], st["sorted_gseg"], st["seg_start"],
                       st["price"], st["tenant"], st["seq"], args[0],
                       eng.level_off, eng.tree.strides, st["owner"],
                       st["limit"], eng.k, health=health)
    down = health == R.HEALTH_DOWN
    assert (masked[2][down] == -1).all()


@pytest.mark.cuda
def test_alone_engine_run_on_card_matches_cpu():
    """One tenant's engine-alone run (``_alone_engine_one``) on the toy
    fleet gives the same performance and cascade waves on the card
    (kernel) as on the CPU (plain version)."""
    _need_cuda()
    from repro_torch.sim import simulator as TS
    cfg = TS.FleetScenarioConfig(
        regime="heavy", n_leaves=32, n_training=2, n_inference=2,
        n_batch=1, duration_s=900.0, seed=1, b_max=32,
        alone="engine_sampled", alone_sample=1)
    out = {}
    for dev in ("cuda", "cpu"):
        topo, _, market, fleet, params = TS.make_fleet(cfg, dev)
        waves = []
        K.LAUNCHES = 0
        perf = [TS._alone_engine_one(fleet, params, market, topo, cfg, i,
                                     waves) for i in range(cfg.n_tenants)]
        out[dev] = (perf, waves, K.LAUNCHES)
    assert out["cuda"][:2] == out["cpu"][:2]
    assert out["cuda"][2] == sum(out["cuda"][1]) > 0
    assert out["cpu"][2] == 0


# ------------------------------------------------ decode_attention, moe_route
def test_model_kernel_wrappers_reject_cpu_tensors():
    """Both model kernels' wrappers refuse CPU tensors before building
    anything: no fallback to the plain version."""
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.moe_route import kernel as RK
    q = torch.zeros(1, 2, 1, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        DK.decode_attention_cuda(q, kv, kv, 3)
    with pytest.raises(ValueError, match="CUDA"):
        RK.route_cuda(torch.zeros(4, 8), 2)
    with pytest.raises(ValueError, match="CUDA"):
        RK.route_cuda(torch.zeros(4, 8), 2, True, torch.bfloat16)


@pytest.mark.parametrize("S,pos,window,want", [
    (16, 5, 0, (0, 5, False)), (16, 40, 0, (0, 15, False)),
    (16, 5, 4, (2, 5, False)), (16, -1, 0, (0, 15, True)),
    (16, 30, 4, (0, 15, True)), (16, 17, 4, (14, 15, False))])
def test_decode_valid_range(S, pos, window, want):
    """The wrapper's position range equals the plain version's mask."""
    from repro_torch.kernels.decode_attention.kernel import valid_range
    assert valid_range(S, pos, window) == want
    t = np.arange(S)
    mask = (t <= pos) & ((t > pos - window) if window else True)
    lo, hi, uniform = want
    if uniform:
        assert not mask.any()
    else:
        assert np.array_equal(np.flatnonzero(mask), np.arange(lo, hi + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,G,hd,pos,window", [
    (4, 1064, 16, 1, 128, 1054, 0), (4, 1064, 16, 1, 128, 0, 0),
    (4, 1064, 16, 1, 128, 1063, 256), (1, 1000, 2, 8, 128, 777, 0),
    (2, 48, 2, 2, 16, 20, 0), (1, 37, 1, 3, 80, 36, 7),
    (1, 16, 2, 2, 64, -1, 0),
    # split-KV: one split (pos inside the first), two, a ragged last
    # split (S and the valid count not multiples of the split), a window
    # shorter than a split, a window over several splits, the uniform
    # case over 8 splits, G 8, hd 80 and 256, a scalar-load hd
    (4, 1064, 16, 1, 128, 40, 0), (4, 1064, 16, 1, 128, 130, 0),
    (4, 1064, 16, 1, 128, 1054, 300), (4, 1064, 16, 1, 128, -1, 0),
    (2, 1000, 3, 1, 128, 998, 0), (4, 1064, 16, 1, 128, 1054, 50),
    (1, 600, 2, 8, 64, 555, 0), (2, 700, 4, 2, 80, 650, 0),
    (1, 600, 4, 1, 256, 599, 0), (1, 300, 2, 8, 256, 250, 0),
    (1, 300, 2, 3, 37, 299, 0),
    # the full-width model paths: gemma3 (a local layer's window cutting
    # at lo 31), qwen3, danube (hd 80 under its 4,096 window), paligemma
    # (MQA: K 1, G 8, hd 256), whisper's cross-attention (every frame)
    (4, 1064, 16, 2, 128, 1054, 1024), (4, 1064, 8, 2, 128, 1054, 0),
    (2, 4184, 8, 4, 80, 4170, 4096), (2, 280, 1, 8, 256, 279, 0),
    (2, 1500, 8, 1, 64, 1499, 0),
    # plans of more than 8 splits (K 1, and 2 groups over 8,000
    # positions), G exactly 2, 4 and 8 at hd 80, G above 8 (two blocks of
    # query rows), a window over tens of splits
    (1, 4096, 1, 1, 128, 4095, 0), (1, 8192, 2, 4, 80, 8000, 0),
    (1, 8192, 2, 2, 80, 8191, 0), (1, 8192, 2, 8, 80, 6000, 0),
    (2, 3000, 1, 2, 256, 2999, 0), (1, 5000, 1, 12, 64, 4999, 0),
    (1, 9000, 1, 8, 128, 8500, 4000), (1, 2000, 1, 1, 80, 1999, 0)])
def test_decode_attention_kernel_matches_plain_on_card(dtype, B, S, K, G,
                                                       hd, pos, window):
    """Tolerance 2e-5 (float32) / 3e-2 (bfloat16), as the reference's
    kernel tests: the same float32 sums taken in another order (the
    splits are merged by log-sum-exp)."""
    _need_cuda()
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(B * 1000 + S + pos)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", dt) for s in ((B, K, G, hd), (B, S, K, hd),
                                         (B, S, K, hd)))
    before = DK.LAUNCHES
    got = DK.decode_attention_cuda(q, k, v, pos, window)
    want = DR.decode_attention_ref(q, k, v, pos, window)
    torch.cuda.synchronize()
    assert DK.LAUNCHES == before + 1 and got.dtype == dt
    tol = 3e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k,renorm", [
    (4, 64, 8, False), (1024, 64, 8, False), (1024, 64, 8, True),
    (7, 8, 2, True), (300, 384, 8, True), (5, 512, 64, False)])
def test_moe_route_kernel_matches_plain_on_card(T, E, k, renorm):
    """Indices exact; weights rtol 1e-5 / atol 1e-6 (the softmax sum
    taken in another order).  Every third token's logits tie in pairs."""
    _need_cuda()
    from repro_torch.kernels.moe_route import kernel as RK
    from repro_torch.kernels.moe_route import ref as RR
    rng = np.random.default_rng(T + E + k)
    x = rng.standard_normal((T, E)).astype(np.float32)
    x[::3] = np.repeat(x[::3, : (E + 1) // 2], 2, axis=1)[:, :E]
    logits = torch.from_numpy(x).cuda()
    before = RK.LAUNCHES
    w, idx = RK.route_cuda(logits, k, renorm)
    w0, idx0 = RR.route_ref(logits, k, renorm)
    torch.cuda.synchronize()
    assert RK.LAUNCHES == before + 1
    assert torch.equal(idx, idx0)
    torch.testing.assert_close(w, w0, rtol=1e-5, atol=1e-6)


ROUTE_DENSE_EK = ((8, 1), (8, 8), (60, 1), (60, 8), (64, 1), (64, 8),
                  (64, 64), (512, 1), (512, 8), (512, 64))


def _tied_logits(T, E, seed, dev="cuda"):
    """Random logits: every third token's experts tied in pairs, every
    fifth token's all equal (the tie straddles the k-th place), and
    every seventh token's probabilities +0 but one (underflow)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, E)).astype(np.float32)
    x[::3] = np.repeat(x[::3, : (E + 1) // 2], 2, axis=1)[:, :E]
    x[1::5] = 0.5
    x[2::7, E // 2] = 150.0
    return torch.from_numpy(x).to(dev)


def _poison_pool(shape, dtype):
    """Leave a freed block of NaN bits in the caching allocator, so the
    next ``torch.empty`` of this size finds garbage, not zeros."""
    junk = torch.full(shape, float("nan"), dtype=dtype, device="cuda")
    del junk


def _bf16_steps(a, b):
    """Largest distance, in bfloat16 steps, between two arrays of
    bfloat16 values that are all >= +0."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max()) if a.numel() else 0


def _check_route_dense(logits, k, renorm, dt, got):
    """The kernel's dense row equals the scatter of its own w and idx bit
    for bit, with no -0.0; its w and idx equal the plain version's
    (indices exact, weights rtol 1e-5 / atol 1e-6); its dense row
    equals the plain version's within the weight tolerance (float32) or
    one bfloat16 step (a weight one float32 ulp away may round to the
    neighbouring bfloat16 value)."""
    from repro_torch.kernels.moe_route import ref as RR
    w, idx, dense = got
    w0, idx0, dense0 = RR.route_dense_ref(logits, k, renorm, dt)
    own = torch.zeros(dense.shape, dtype=torch.float32, device=w.device)
    own.scatter_(1, idx.long(), w)
    torch.cuda.synchronize()
    assert dense.dtype == dt and dense.shape == logits.shape
    assert torch.equal(idx, idx0)
    torch.testing.assert_close(w, w0, rtol=1e-5, atol=1e-6)
    assert torch.equal(dense.view(torch.uint8),
                       own.to(dt).view(torch.uint8))
    assert not torch.signbit(dense.float()).any()
    if dt == torch.float32:
        torch.testing.assert_close(dense, dense0, rtol=1e-5, atol=1e-6)
    else:
        assert _bf16_steps(dense, dense0) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("E,k", ROUTE_DENSE_EK)
@pytest.mark.parametrize("T", [0, 1, 4, 1024, 4097])
def test_moe_route_dense_matches_scatter_on_card(T, E, k, renorm, dtype):
    """One launch writes w, idx and the dense combine weights (E 60 and
    512: lanes past E; T 0: no launch)."""
    _need_cuda()
    from repro_torch.kernels.moe_route import kernel as RK
    dt = getattr(torch, dtype)
    logits = _tied_logits(T, E, T + 7 * E + k)
    _poison_pool((T, E), dt)
    before = RK.LAUNCHES
    got = RK.route_cuda(logits, k, renorm, dt)
    assert RK.LAUNCHES == before + (1 if T else 0)
    _check_route_dense(logits, k, renorm, dt, got)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [4, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_route_dense_in_cuda_graph_on_card(dtype, T):
    """The captured sequences product -> router with dense weights (a
    kernel node before it) and copy -> router (a memcpy node before it)
    give what eager calls give on the same logits, on two inputs
    replayed through one graph."""
    _need_cuda()
    from repro_torch.kernels.moe_route import kernel as RK
    from repro_torch.kernels.moe_route import ops as RO
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn((T, 2048), generator=gen, device="cuda").to(dt)
    router = torch.randn((2048, 64), generator=gen, device="cuda") * 0.05
    src = torch.empty((T, 64), device="cuda")

    def product():
        logits = x.to(torch.float32) @ router
        return logits, RK.route_cuda(logits, 8, False, dt)

    def copied():
        logits = torch.empty_like(src)
        logits.copy_(src)
        return logits, RK.route_cuda(logits, 8, True, dt)
    for seq in (product, copied):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            seq()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, out = seq()
        renorm = seq is copied
        for seed in (1, 2):
            x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
            src.copy_(_tied_logits(T, 64, seed))
            graph.replay()
            torch.cuda.synchronize()
            eager_logits = (x.to(torch.float32) @ router if seq is product
                            else src)
            torch.testing.assert_close(logits, eager_logits)
            want = RO.route_dense(logits, 8, renorm, dt)
            torch.cuda.synchronize()
            for a, b in zip(out, want):
                assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            _check_route_dense(logits, 8, renorm, dt, tuple(out))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dense_one_router_launch_on_card(dtype):
    """``moe_dense`` on the card launches the router once a call and no
    zeros / scatter / cast for its combine weights, and matches the same
    layer on the CPU (1e-4 float32, as the reduced servers' logits;
    3e-2 bfloat16, the serving tests' bfloat16 tolerance)."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_route import kernel as RK
    from repro_torch.models import layers as TL
    from repro_torch.models import model as TM
    cfg = get_config("olmoe-1b-7b").reduced()
    dt = getattr(torch, dtype)
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    moe = {k: (v if k == "router" else v.to(dt))
           for k, v in TM._unstack(tp["blocks"][0])[0]["moe"].items()}
    moe_gpu = {k: v.cuda() for k, v in moe.items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)).to(dt)
    TL.moe_dense(moe_gpu, cfg, x.cuda())          # build, warm up
    torch.cuda.synchronize()
    before = RK.LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = TL.moe_dense(moe_gpu, cfg, x.cuda())
        torch.cuda.synchronize()
    assert RK.LAUNCHES == before + 1
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    routed = [n for n in names if "route_kernel" in n]
    assert len(routed) == 1, names
    assert not [n for n in names if "scatter" in n.lower()], names
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    torch.testing.assert_close(out.cpu().float(),
                               TL.moe_dense(moe, cfg, x).float(),
                               rtol=tol, atol=tol)


# ---------------------------------------------- dense and enc-dec models
def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _greedy(params, cfg, batch, steps):
    """Prefill, then ``steps`` greedy decode steps: (tokens, logits)."""
    from repro_torch.models import model as TM
    S = batch["tokens"].shape[1]
    P = cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0
    logits, cache = TM.prefill(params, cfg, batch, max_len=P + S + steps)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    out = [tok]
    for t in range(steps):
        logits, cache = TM.decode_step(params, cfg, cache, tok, P + S + t)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, 1), logits


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-27b", "whisper-base"])
def test_reduced_model_on_card_matches_cpu(arch):
    """Reduced gemma3 (windows of 16 cut by 20-token prompts, period 2)
    through the Server, and reduced whisper (the encoder, cross-attention
    through the decode kernel) through prefill and decode, on the card
    against the same runs on the CPU in float32: the same tokens, the
    last logits within 1e-4, the decode kernel once per self- and
    cross-attention layer per decode step."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as TM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = DK.LAUNCHES
    if arch == "gemma3-27b":
        shape = dict(requests=3, prompt_len=20, max_new=4, slots=2)
        gpu = serve(arch, cfg=cfg, params=_to(tp, "cuda"), device="cuda",
                    **shape)
        cpu = serve(arch, cfg=cfg, params=tp, device="cpu", **shape)
        assert [r.out for r in gpu.requests] == \
            [r.out for r in cpu.requests]
        got, want = gpu.server.last_logits.cpu(), cpu.server.last_logits
        launches = cfg.num_layers * gpu.decode_steps
    else:
        rng = np.random.default_rng(5)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 20)).astype(np.int32)),
            "encoder_embeds": torch.from_numpy(rng.standard_normal(
                (2, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32))}
        gtok, got = _greedy(_to(tp, "cuda"), cfg, _to(batch, "cuda"), 8)
        ctok, want = _greedy(tp, cfg, batch, 8)
        assert torch.equal(gtok.cpu(), ctok)
        got = got.cpu()
        launches = 2 * cfg.num_layers * 8        # self + cross, 8 steps
    assert DK.LAUNCHES - before == launches
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_init_peak_on_card(dtype):
    """``init_params`` fills each stacked leaf in place: its peak
    allocation stays under the parameters' own bytes plus the largest
    float32 draw (the embedding's), for a config of 3 superblocks of
    period 2 (the full-width gemma3 needs 54.0 GB plus 5.6 GB so)."""
    _need_cuda()
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(
        get_config("gemma3-27b").reduced(num_layers=6), param_dtype=dtype)
    assert cfg.plan_blocks() == (0, 2, 3, 0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = TM.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), "cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    draw = 4 * cfg.vocab_size * cfg.d_model
    assert params["blocks"][1]["mlp"]["wd"].shape[0] == 3
    assert held < peak <= held + draw, (held, peak, draw)


# ------------------------------------------------------------------ ssd_scan
def test_ssd_wrapper_rejects_cpu_tensors():
    """The SSD kernel's wrapper refuses CPU tensors before building
    anything: no fallback to the plain version."""
    from repro_torch.kernels.ssd_scan import kernel as SK
    args = sample_inputs(1, 8, 2, 16, 16, 0, "cpu", torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        SK.ssd_scan_cuda(*args, 16)


# (B, S, H, P, N, chunk, strided)
SSD_CARD_CASES = [
    (2, 64, 4, 16, 32, 16, False), (1, 40, 4, 16, 32, 16, True),
    (1, 8, 8, 16, 16, 16, True), (2, 300, 3, 24, 40, 128, False),
    (1, 1000, 48, 64, 128, 256, True),
    # the chunk-parallel passes: S < Q, S = Q (one chunk), Q 1,024 whole
    # and partial, B 2 strided, P over one 64-row tile, N 256
    (1, 100, 4, 64, 128, 256, True), (1, 256, 4, 64, 128, 256, True),
    (1, 2048, 4, 64, 128, 1024, True), (1, 1500, 2, 64, 128, 1024, False),
    (2, 700, 8, 64, 128, 256, True), (1, 300, 2, 80, 64, 64, True),
    (1, 512, 2, 64, 256, 128, False), (2, 40, 8, 16, 16, 16, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,strided", SSD_CARD_CASES)
def test_ssd_scan_kernel_matches_plain_on_card(dtype, B, S, H, P, N, chunk,
                                               strided):
    """y within 3e-4 (float32) / 4e-2 (bfloat16) of the plain version,
    the reference's kernel tolerances: the float32 sums run in another
    order, and for bfloat16 inputs the plain version rounds C Bᵀ to
    bfloat16 as the reference does while the kernel rounds the decayed
    Gram and the carried state.  The final state is float32 in both
    and taken from the same rounded inputs: 3e-4 in both dtypes.  Partial last
    chunks (S 40, 8, 300, 1,000) and strided slices included; one call
    counts one launch."""
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR
    dt_ = getattr(torch, dtype)
    args = sample_inputs(B, S, H, P, N, S + N, "cuda", dt_, strided)
    before = SK.LAUNCHES
    y, st = SK.ssd_scan_cuda(*args, chunk)
    y0, st0 = SR.ssd_scan_ref(*args, chunk)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == before + 1
    assert y.dtype == dt_ and st.dtype == torch.float32
    tol = 4e-2 if dt_ == torch.bfloat16 else 3e-4
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(st, st0, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk,strided", SSD_CARD_CASES)
def test_ssd_scan_bf16_y_close_on_card(B, S, H, P, N, chunk, strided):
    """bfloat16 y within 1e-2 (rtol and atol) of the plain version: a
    second, closer hold on the bfloat16 path, whose products (mma.sync
    and ldmatrix fragments) the float32 cases never run.  The limit is
    set from readings: about one bfloat16 step of y, 2e-3 to 3.9e-3 at
    chip_smoke's bfloat16 cases, where y reaches ~0.5."""
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR
    args = sample_inputs(B, S, H, P, N, S + N, "cuda", torch.bfloat16,
                         strided)
    y, _ = SK.ssd_scan_cuda(*args, chunk)
    y0, _ = SR.ssd_scan_ref(*args, chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y0.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_ssd_scan_wrapper_refuses_layouts_on_card():
    """A layout the kernel cannot read raises; it is never read wrongly."""
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK
    x, dt, A, Bm, Cm = sample_inputs(1, 32, 2, 16, 16, 1, "cuda",
                                     torch.float32, strided=False)
    with pytest.raises(ValueError, match="strides"):
        SK.ssd_scan_cuda(x.transpose(2, 3).contiguous().transpose(2, 3),
                         dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="contiguous"):
        SK.ssd_scan_cuda(x, dt.transpose(1, 2).contiguous().transpose(1, 2),
                         A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="chunk"):
        SK.ssd_scan_cuda(x, dt, A, Bm, Cm, SK.QMAX + 1)



# ------------------------------------------- event path and recovery
def _facade_fingerprints(topo, events, dev):
    from repro_torch.market_torch.bridge import BatchMarket
    from repro_torch.sim.traces import apply_event
    bm = BatchMarket(topo, capacity=1 << 10, n_tenants=16, device=dev)
    calls = []
    bm.on_transfer.append(lambda *a: calls.append(a))
    leaves = [leaf for root in topo.roots.values()
              for leaf in topo.leaves_of(root)]
    out = []
    for e in events:
        apply_event(bm, e)
        out.append(([bm.owner_of(leaf) for leaf in leaves],
                    [bm.market_rate(leaf) for leaf in leaves], bm.settle(),
                    dict(bm.stats), list(calls),
                    [(o.slot, o.seq, o.active) for o in bm.orders.values()]))
    return out


@pytest.mark.cuda
def test_facade_trace_on_card_matches_cpu():
    """A two-rtype facade trace: after every event the card's facade
    (clearing kernel) equals the CPU's (plain version) — owners, rates,
    settle bills, stats, callbacks and orders — and the kernel ran."""
    _need_cuda()
    from repro_torch.core.market import Market
    from repro_torch.core.topology import build_cluster
    from repro_torch.sim.traces import market_trace
    topo = build_cluster({"H100": 8, "A100": 8}, gpus_per_host=2,
                         hosts_per_rack=2, racks_per_zone=1)
    events = market_trace(Market(topo), 2, 120)
    K.LAUNCHES = 0
    gpu = _facade_fingerprints(topo, events, "cuda")
    assert K.LAUNCHES > len(events)
    cpu = _facade_fingerprints(topo, events, "cpu")
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        assert g == c, (i, events[i])
    assert cpu[-1][3]["transfers"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves,k,seed", [(64, 4, 0), (1024, 8, 1)])
def test_clear_and_topk_on_card_match_cpu(n_leaves, k, seed):
    _need_cuda()
    eng, st = _book(build_tree(n_leaves), k, seed, "cuda")
    ceng, cst = _book(build_tree(n_leaves), k, seed, "cpu")
    K.LAUNCHES = 0
    got = eng.clear(st) + eng.clear_topk(st)
    assert K.LAUNCHES == 2
    want = ceng.clear(cst) + ceng.clear_topk(cst)
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), j


def _recovery_run(dev, workdir, crashes=(), resume=False):
    from repro_torch.market_torch.engine import build_tree as bt
    from repro_torch.sim import simulator as TS
    from repro_torch.sim.faults import FaultEvent, FaultInjector, \
        rack_failure_storm, zone_supply_shock
    from repro_torch.sim.recovery import CrashSafeRunner
    cfg = TS.FleetScenarioConfig(
        regime="heavy", n_leaves=64, n_training=3, n_inference=3,
        n_batch=2, duration_s=600.0, tick_s=60.0, seed=3, k=4, b_max=64,
        per_tenant_bids=4, alone="none")
    events = (rack_failure_storm(bt(64), 120.0, 400.0, 180.0, 150.0, seed=9)
              + zone_supply_shock(240.0, 420.0, zone=0)
              + [FaultEvent(t, "crash", phase=ph) for t, ph in crashes])
    topo, _, market, fleet, params = TS.make_fleet(cfg, dev)
    TS._seed_floors(market, topo)
    runner = CrashSafeRunner(market, fleet, "H100", str(workdir),
                             injector=FaultInjector(events))
    go = runner.resume if resume else runner.run
    fs, stats = go(params, 600.0, 60.0)
    est = to_numpy(market.states["H100"])
    return ({k: est[k] for k in ("owner", "rate", "bills", "health")},
            fleet.performance(params, fs, 600.0).cpu().numpy(), stats,
            int(est["waves"]))


def _assert_runs_equal(a, b):
    for key in a[0]:
        np.testing.assert_array_equal(a[0][key], b[0][key], err_msg=key)
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["mid_wal", "post_step"])
def test_kill_and_resume_on_card(tmp_path, phase):
    """A 64-leaf fleet run on the card, killed mid-run and resumed on
    the card, equals the uninterrupted card run; the resume restored
    its snapshot onto the card and cleared with the kernel once per
    cascade wave."""
    _need_cuda()
    from repro_torch.sim.recovery import SimulatedCrash
    base = _recovery_run("cuda", tmp_path / "base")
    with pytest.raises(SimulatedCrash):
        _recovery_run("cuda", tmp_path / "kill", [(300.0, phase)])
    K.LAUNCHES = 0
    got = _recovery_run("cuda", tmp_path / "kill", resume=True)
    _assert_runs_equal(got, base)
    # resumed after epoch 4's snapshot: the waves since then
    assert 0 < K.LAUNCHES < base[3]
    _assert_runs_equal(base, _recovery_run("cpu", tmp_path / "cpu"))


# ----------------------------------------------------------------- training
def _train_copy(tree, dev):
    """A deep copy of a parameter tree on ``dev`` (a train step updates
    its state in place)."""
    if isinstance(tree, dict):
        return {k: _train_copy(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_train_copy(v, dev) for v in tree]
    return tree.detach().to(dev, copy=True)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m",
                                  "jamba-v0.1-52b"])
def test_reduced_train_on_card_matches_cpu(arch):
    """A reduced model (float32, no TF32) on the card against the CPU
    from the same parameters: every first-step gradient leaf within atol
    1e-5 + rtol 1e-3 and non-zero (nothing lost through a kernel), then
    3 steps of ``make_train_step`` with losses within 1e-4.  The card
    launches the router and the scan once per layer in the forward and
    once more in the remat recompute (every layer here is in a
    superblock): the kernels, never the plain versions."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels.moe_route import kernel as RK
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.models import model as TM
    from repro_torch.models import steps as TS
    from repro_torch.optim import AdamWConfig, make_train_state
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    head, p, n_super, tail = cfg.plan_blocks()
    assert head == tail == 0 and cfg.remat
    plan = cfg.layer_plan()
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 20, 2, 0))
    batches = [{"tokens": torch.from_numpy(data.batch(i)["tokens"])}
               for i in range(3)]
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = _train_copy(params, "cuda")
    lg, gg = TS.loss_and_grads(card, cfg, _to(batches[0], "cuda"))
    lc, gc_ = TS.loss_and_grads(params, cfg, batches[0])
    assert abs(float(lg) - float(lc)) <= 1e-4
    for g, c in zip(gg, gc_):
        assert float(g.abs().max()) > 0
        torch.testing.assert_close(g.cpu(), c, rtol=1e-3, atol=1e-5)
    opt = AdamWConfig(lr=1e-2, warmup_steps=2)
    step = TS.make_train_step(cfg, opt)
    st_card, st_cpu = make_train_state(card, opt), make_train_state(
        params, opt)
    before = (RK.LAUNCHES, SK.LAUNCHES)
    for b in batches:
        st_card, mg = step(st_card, _to(b, "cuda"))
        st_cpu, mc = step(st_cpu, b)
        assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4
    assert RK.LAUNCHES - before[0] == 3 * 2 * sum(s.moe for s in plan)
    assert SK.LAUNCHES - before[1] == 3 * 2 * sum(s.kind == "ssm"
                                                  for s in plan)


def _moe_ep_run(cfg, p, x, dev):
    """``moe_ep`` on a one-rank (1, 1) mesh on ``dev`` (NCCL on the card,
    gloo on the CPU) and the dispatch it recorded (``DISPATCH``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as TL
    mesh = make_mesh((1, 1), ("data", "model"), dev)
    p = {k: v.to(dev) for k, v in p.items()}
    x = x.to(dev)
    TL.DISPATCH = []
    try:
        y = TL.moe_ep(p, cfg, x, mesh=mesh, ep_axis="model")
        (buf_tok, counts, _, _, _), = TL.DISPATCH
    finally:
        TL.DISPATCH = None
    return y.cpu(), buf_tok.cpu(), counts.cpu()


@pytest.mark.cuda
def test_moe_ep_on_card_matches_cpu():
    """``moe_ep`` (reduced OLMoE in bfloat16, capacity factor 1.0, so
    pairs drop) on a one-rank NCCL mesh equals its run on the CPU:
    ``buf_tok`` and the per-expert counts exactly, the output within the
    serving checks' bfloat16 bound (3e-2).  x and the router are
    multiples of 2**-6 and 2**-8, so the float32 logits are exact sums on
    both devices and the routing is the same."""
    _need_cuda()
    from repro_torch.configs import get_config
    cfg = get_config("olmoe-1b-7b").reduced(param_dtype="bfloat16",
                                            capacity_factor=1.0)
    g = torch.Generator().manual_seed(0)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    x = ((0.3 * torch.randn(D, generator=g)
          + 0.5 * torch.randn(4, 32, D, generator=g)) * 64).round() \
        .clamp(-63, 63) / 64
    p = {"router": ((0.1 * torch.randn(D, E, generator=g)) * 256).round()
         .clamp(-32, 32) / 256}
    for k, shape in (("wg", (E, D, F)), ("wu", (E, D, F)), ("wd", (E, F, D))):
        p[k] = (0.1 * torch.randn(shape, generator=g)).to(torch.bfloat16)
    x = x.to(torch.bfloat16)
    y, buf, counts = _moe_ep_run(cfg, p, x, "cuda")
    y0, buf0, counts0 = _moe_ep_run(cfg, p, x, "cpu")
    assert torch.equal(buf, buf0) and torch.equal(counts, counts0)
    assert int((counts0 - 32).clamp(min=0).sum()) > 0
    torch.testing.assert_close(y.float(), y0.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
def test_trainer_on_card_matches_cpu(tmp_path):
    """The ``Trainer`` on a one-rank NCCL group (its (1, 1) mesh: the MoE
    layers run ``moe_ep``) takes 4 reduced-OLMoE steps (float32, capacity
    factor 1.0) equal to the CPU's within 1e-4, both resumed from one
    step-0 checkpoint; the router launches twice per layer a step."""
    _need_cuda()
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.moe_route import kernel as RK
    from repro_torch.models import model as TM
    from repro_torch.optim import AdamWConfig, make_train_state
    from repro_torch.train.trainer import TrainConfig, Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("olmoe-1b-7b").reduced(capacity_factor=1.0)
    opt = AdamWConfig(lr=1e-2, warmup_steps=2)
    state0 = make_train_state(TM.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), opt)
    reps, launches = [], []
    for dev in ("cuda", "cpu"):
        CheckpointManager(str(tmp_path / dev)).save(0, state0)
        before = RK.LAUNCHES
        reps.append(Trainer(cfg, DataConfig(cfg.vocab_size, 32, 4, 0), opt,
                            TrainConfig(steps=4, checkpoint_every=100,
                                        checkpoint_dir=str(tmp_path / dev)),
                            device=dev).run(resume=True))
        launches.append(RK.LAUNCHES - before)
    assert [r.restores for r in reps] == [1, 1]
    np.testing.assert_allclose(reps[0].losses, reps[1].losses, rtol=0,
                               atol=1e-4)
    assert launches == [4 * 2 * sum(s.moe for s in cfg.layer_plan()), 0]


@pytest.mark.cuda
def test_trainer_resizes_across_cards(tmp_path):
    """The ``Trainer`` under ``ScheduledBroker({0: 1, 4: 2}, 1)`` on two
    ranks, each on its own card (NCCL for CUDA tensors; ``spawn_local``
    sets no ``LOCAL_RANK``, so each rank binds the card of its rank),
    grows from one card to two at step 4: both ranks report ``resizes ==
    [(4, 1, 2)]``; at the resize each rank receives rank 0's whole state
    after step 3 (its digest) and keeps its FSDP block of it; after each
    step each rank's blocks are that block of the state gathered whole,
    the two ranks' blocks differ after each of steps 4-7 and the
    gathered states are bit-equal; and the losses equal those of the
    same run on two CPU gloo ranks within 1e-4 (reduced OLMoE, float32,
    capacity factor 1.0; both resumed from one step-0 checkpoint).
    Needs two cards."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (one NCCL rank per card)")
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import local
    from repro_torch.launch.mesh import spawn_local
    from repro_torch.models import model as TM
    from repro_torch.optim import AdamWConfig, make_train_state
    cfg = get_config("olmoe-1b-7b").reduced(capacity_factor=1.0)
    opt = AdamWConfig(lr=1e-2, warmup_steps=2)
    state0 = make_train_state(TM.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), opt)
    got = {}
    for dev, backend in (("cuda", "cpu:gloo,cuda:nccl"), ("cpu", "gloo")):
        CheckpointManager(str(tmp_path / dev)).save(0, state0)
        out = tmp_path / f"out_{dev}"
        out.mkdir()
        spawn_local(local.trainer_rank, 2, cfg,
                    DataConfig(cfg.vocab_size, 32, 4, 0), opt, {0: 1, 4: 2},
                    8, str(tmp_path / dev), str(out), dev, timeout=120,
                    backend=backend)
        got[dev] = [np.load(out / f"rank{r}.npz") for r in range(2)]
    card = got["cuda"]
    assert [int(g["card"]) for g in card] == [0, 1]
    for g in card + got["cpu"]:
        assert g["resizes"].tolist() == [[4, 1, 2]]
        assert int(g["restores"]) == 1
    assert card[1]["digest_steps"].tolist() == [4, 5, 6, 7]
    np.testing.assert_array_equal(card[0]["digests"][4:], card[1]["digests"])
    for g in card:
        np.testing.assert_array_equal(g["local_digests"], g["shard_digests"])
        np.testing.assert_array_equal(g["resize_in"], card[0]["digests"][3:4])
        np.testing.assert_array_equal(g["resize_blocks"], g["resize_shards"])
    assert (card[0]["local_digests"][4:] != card[1]["local_digests"]).all()
    np.testing.assert_allclose(card[0]["losses"], got["cpu"][0]["losses"],
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_grad_on_card(dtype, renorm):
    """The router Function's logits gradient on the card equals the same
    Function's on the CPU on tied logits (both follow their forward's
    lowest-index idx) and autograd through the plain version on the card
    on untied logits, within 1e-6."""
    _need_cuda()
    from repro_torch.kernels.moe_route import ops as RO
    from repro_torch.kernels.moe_route import ref as RR
    dt = getattr(torch, dtype)
    gen = np.random.default_rng(3)
    untied = torch.from_numpy(gen.standard_normal((300, 64))
                              .astype(np.float32))
    up = torch.from_numpy(gen.standard_normal((300, 64))
                          .astype(np.float32)).to(dt)

    def grad(logits, fn):
        logits = logits.detach().clone().requires_grad_(True)
        _, _, dense = fn(logits, 8, renorm, dt)
        return torch.autograd.grad(
            (dense.float() * up.to(logits.device).float()).sum(), logits)[0]
    tied = _tied_logits(300, 64, 5)
    got = grad(tied.cuda(), RO.route_dense)
    torch.testing.assert_close(got.cpu(), grad(tied.cpu(), RO.route_dense),
                               rtol=0, atol=1e-6)
    got = grad(untied.cuda(), RO.route_dense)
    torch.testing.assert_close(got, grad(untied.cuda(), RR.route_dense_ref),
                               rtol=0, atol=1e-6)
    assert float(got.abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 20, 8, 16, 16, 16),
                                             (1, 1000, 48, 64, 128, 256),
                                             (1, 1100, 4, 64, 128, 512),
                                             (1, 2500, 4, 64, 128, 1024)])
def test_ssd_grad_on_card_matches_cpu(B, S, H, P, N, chunk):
    """The SSD Function's gradients of the conv output (x, Bm, Cm as its
    strided slices), dt and A on the card (the kernel's forward, one
    launch of the backward kernel) equal the CPU's (the plain version
    under autograd) within 3e-4 (float32)."""
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ops as SO
    xs, dt, A, _, _ = sample_inputs(B, S, H, P, N, 9, "cpu", torch.float32)
    xbc = xs._base
    up = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (B, S, H, P)).astype(np.float32))

    def grads(dev):
        ins = [t.detach().to(dev, copy=True).requires_grad_(True)
               for t in (xbc, dt, A)]
        x, Bm, Cm = torch.split(ins[0], [H * P, N, N], dim=-1)
        y, _ = SO.ssd_scan(x.reshape(B, S, H, P), ins[1], ins[2], Bm, Cm,
                           chunk)
        return torch.autograd.grad((y * up.to(dev)).sum(), ins)
    before = SK.BACKWARD_LAUNCHES
    card = grads("cuda")
    torch.cuda.synchronize()
    assert SK.BACKWARD_LAUNCHES == before + 1
    for g, c in zip(card, grads("cpu")):
        assert float(c.abs().max()) > 0
        torch.testing.assert_close(g.cpu(), c, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 20, 8, 16, 16, 16),
                                             (2, 300, 3, 24, 40, 128),
                                             (1, 1000, 48, 64, 128, 256),
                                             (1, 1100, 4, 64, 128, 512),
                                             (1, 2500, 4, 64, 128, 1024)])
def test_ssd_backward_bf16_on_card_matches_plain(B, S, H, P, N, chunk,
                                                 with_state):
    """The bfloat16 backward kernel (strided x, Bm, Cm as ``ssd_block``
    hands them over) against the plain version under autograd on the
    same card tensors, within ``kernel.BWD_BF16_TOL`` of each gradient's
    largest magnitude, with and without a gradient on the final state;
    gx, gBm and gCm come back in bfloat16, gdt and gA in float32."""
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR
    args = sample_inputs(B, S, H, P, N, 11, "cuda", torch.bfloat16)
    rng = np.random.default_rng(12)
    g_y = torch.from_numpy(rng.standard_normal((B, S, H, P))
                           .astype(np.float32)).cuda().bfloat16()
    g_s = torch.from_numpy(rng.standard_normal((B, H, P, N))
                           .astype(np.float32)).cuda() if with_state else None
    got = SK.ssd_scan_backward_cuda(*args, chunk, g_y, g_s)
    want = SR.ssd_scan_backward_ref(args, chunk, g_y, g_s, (True,) * 5)
    torch.cuda.synchronize()
    for g, w, dt_ in zip(got, want, (torch.bfloat16, torch.float32,
                                     torch.float32, torch.bfloat16,
                                     torch.bfloat16)):
        assert g.dtype == dt_ and g.shape == w.shape
        scale = float(w.float().abs().max())
        assert scale > 0 and bool(torch.isfinite(g).all())
        assert float((g.float() - w.float()).abs().max()) <= \
            SK.BWD_BF16_TOL * scale


def _ssd_backward_case(dtype, B, S, H, P, N, seed):
    """Card inputs of the backward: x, dt, A, Bm, Cm as ``ssd_block``
    hands them over, the gradient of y in x's dtype and a float32
    gradient of the final state."""
    args = sample_inputs(B, S, H, P, N, seed, "cuda", dtype)
    rng = np.random.default_rng(seed + 1)
    g_y = torch.from_numpy(rng.standard_normal((B, S, H, P))
                           .astype(np.float32)).cuda().to(dtype)
    g_s = torch.from_numpy(rng.standard_normal((B, H, P, N))
                           .astype(np.float32)).cuda()
    return args, g_y, g_s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_is_bit_equal_run_to_run(dtype):
    """Two launches of the backward kernel on the same inputs give the
    same bits: the head groups' sums and the row sums run in a fixed
    order, with no atomics (the sharded step's 1e-6 comparisons of
    DTensor gradients rest on it)."""
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK
    args, g_y, g_s = _ssd_backward_case(getattr(torch, dtype), 2, 600, 8,
                                        64, 128, 13)
    first = SK.ssd_scan_backward_cuda(*args, 256, g_y, g_s)
    second = SK.ssd_scan_backward_cuda(*args, 256, g_y, g_s)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 3, "H"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_head_groups_on_card(groups, dtype):
    """The backward kernel at 1, 3 and H head groups (H 8: groups of 8;
    3, 3 and 2; 1 head) against the plain version under autograd on the
    same card tensors, one launch each: float32 within 3e-4, bfloat16
    within ``kernel.BWD_BF16_TOL`` of each gradient's largest magnitude
    (dG rounds once a group, so the bfloat16 bits depend on the split).
    A split that leaves a group empty is refused before a launch."""
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR
    dt_ = getattr(torch, dtype)
    H = 8
    args, g_y, g_s = _ssd_backward_case(dt_, 2, 300, H, 64, 128, 17)
    before = SK.BACKWARD_LAUNCHES
    got = SK.ssd_scan_backward_cuda(*args, 128, g_y, g_s,
                                    groups=H if groups == "H" else groups)
    want = SR.ssd_scan_backward_ref(args, 128, g_y, g_s, (True,) * 5)
    torch.cuda.synchronize()
    assert SK.BACKWARD_LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        scale = float(w.float().abs().max())
        assert scale > 0
        if dt_ == torch.float32:
            torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)
        else:
            assert float((g.float() - w.float()).abs().max()) <= \
                SK.BWD_BF16_TOL * scale
    for bad in (0, 7, H + 1):
        with pytest.raises(ValueError, match="groups"):
            SK.ssd_scan_backward_cuda(*args, 128, g_y, g_s, groups=bad)
    assert SK.BACKWARD_LAUNCHES == before + 1


def test_ssd_backward_wrapper_rejects_cpu_tensors():
    """The SSD backward kernel's wrapper refuses CPU tensors before
    building anything: no fallback to the plain version."""
    from repro_torch.kernels.ssd_scan import kernel as SK
    args = sample_inputs(1, 8, 2, 16, 16, 0, "cpu", torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        SK.ssd_scan_backward_cuda(*args, 16, torch.zeros(1, 8, 2, 16))


@pytest.mark.cuda
def test_ssd_backward_wrapper_refuses_layouts_on_card():
    """What the backward kernel cannot take raises before a launch: a
    gradient of y whose token is not (H, P) contiguous or of another
    dtype, a final-state gradient not float32, P over 64 or N over 128
    (the widths its accumulators hold)."""
    _need_cuda()
    from repro_torch.kernels.ssd_scan import kernel as SK
    args = sample_inputs(1, 32, 2, 16, 16, 1, "cuda", torch.float32)
    g_y = torch.zeros((1, 32, 2, 16), device="cuda")
    before = SK.BACKWARD_LAUNCHES
    with pytest.raises(ValueError, match="strides"):
        SK.ssd_scan_backward_cuda(
            *args, 16, g_y.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="g_y"):
        SK.ssd_scan_backward_cuda(*args, 16, g_y.bfloat16())
    with pytest.raises(ValueError, match="g_state"):
        SK.ssd_scan_backward_cuda(*args, 16, g_y,
                                  torch.zeros((1, 2, 16, 16), device="cuda",
                                              dtype=torch.bfloat16))
    for P, N in ((80, 16), (16, 256)):
        wide = sample_inputs(1, 32, 2, P, N, 1, "cuda", torch.float32)
        with pytest.raises(ValueError, match="backward takes"):
            SK.ssd_scan_backward_cuda(
                *wide, 16, torch.zeros((1, 32, 2, P), device="cuda"))
    assert SK.BACKWARD_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m"])
def test_dtensor_step_on_card_matches_plain(arch):
    """``make_train_step`` over the one-rank (1, 1) NCCL mesh with the
    state as DTensors placed by ``train_state_specs`` (the router inside
    ``moe_ep``'s ``local_map``, the scan inside the SSM layers') against
    the same step on plain tensors: one rank runs the same local
    operations, so 3 steps' losses and grad norms and the parameters
    after them are equal, and both launch the kernels as often."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels.moe_route import kernel as RK
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as TM
    from repro_torch.models import steps as TS
    from repro_torch.optim import AdamWConfig, make_train_state
    from repro_torch.tree import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    mi = TM.MeshInfo(mesh, ("data",), "model")
    opt = AdamWConfig(lr=1e-2, warmup_steps=2)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 20, 2, 0))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = TS.make_train_step(cfg, opt, mi)
    runs = []
    for placed in (False, True):
        st = make_train_state(_train_copy(params, "cuda"), opt)
        if placed:
            st = SH.distribute(st, SH.train_state_specs(cfg, mesh), mesh)
        before = (RK.LAUNCHES, SK.LAUNCHES)
        metrics = []
        for i in range(3):
            b = {"tokens": torch.from_numpy(data.batch(i)["tokens"]).cuda()}
            if placed:
                b = SH.distribute(b, SH.batch_specs(cfg, mesh, 2), mesh)
            st, m = step(st, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, [t.detach().cpu() for t in
                               tree_leaves(SH.full(st["params"]))],
                     (RK.LAUNCHES - before[0], SK.LAUNCHES - before[1])))
    (plain, p_plain, n_plain), (dt, p_dt, n_dt) = runs
    np.testing.assert_allclose(dt, plain, rtol=1e-6, atol=0)
    for a, b in zip(p_dt, p_plain):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert n_dt == n_plain and sum(n_dt) > 0


@pytest.mark.cuda
def test_dtensor_decode_on_card_matches_plain():
    """Prefill and two decode steps of reduced gemma3 (windowed and
    global layers) over the one-rank (1, 1) NCCL mesh on DTensors placed
    by ``param_specs`` and ``cache_specs_tree`` against the same steps on
    plain tensors: the decode kernel runs on each rank's blocks
    (``local_map``; the cache's sequence is cut over one rank), the
    logits agree within 1e-5 (float32, no TF32) and both launch it as
    often."""
    _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as TM
    from repro_torch.models import steps as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gemma3-27b").reduced()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    mi = TM.MeshInfo(mesh, ("data",), "model")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 20), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1)).cuda()
    runs = []
    for placed in (False, True):
        p = SH.distribute(params, SH.param_specs(cfg, mesh), mesh) \
            if placed else params
        batch = {"tokens": toks}
        if placed:
            batch = SH.distribute(batch, SH.batch_specs(cfg, mesh, 2), mesh)
        logits, cache = TS.make_prefill_step(cfg, 24, mi)(p, batch)
        if placed:
            cache = SH.distribute(cache, SH.cache_specs_tree(cfg, mesh, 2),
                                  mesh)
        before = DK.LAUNCHES
        out = [SH.full(logits)]
        for pos in (20, 21):
            tok = out[-1][:, -1].argmax(-1).to(torch.int32)[:, None]
            if placed:
                tok = SH.distribute(tok, SH.P(("data",), None), mesh)
            logits, cache = TS.make_decode_step(cfg, mi)(p, cache, tok, pos)
            out.append(SH.full(logits))
        runs.append((torch.cat(out, 1).cpu(), DK.LAUNCHES - before))
    (plain, n_plain), (dt, n_dt) = runs
    torch.testing.assert_close(dt, plain, rtol=0, atol=1e-5)
    assert n_dt == n_plain == 2 * cfg.num_layers


def _chip_smoke():
    """The root ``chip_smoke`` module (its shape tables)."""
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _decode_inputs(B, S, K, G, hd, dt, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dt)
                 for s in ((B, K, G, hd), (B, S, K, hd), (B, S, K, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_at_chip_smoke_shapes_on_card(dtype):
    """The kernel against its plain version at every ``DECODE_SHAPES``
    case of chip_smoke.py, and on the ``DECODE_CUT`` caches the whole
    cache and each rank's block (partial mode, every ``DECODE_CUT_RANKS``
    cut) against the plain whole cache and the plain partial: 2e-5
    (float32) / 3e-2 (bfloat16) for the output, 2e-5 for the float32
    ``(o, m, l)`` (``PARTIAL_TOL``)."""
    _need_cuda()
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    cs = _chip_smoke()
    dt = getattr(torch, dtype)
    tol = 3e-2 if dt == torch.bfloat16 else 2e-5
    for path, B, S, K, G, hd, cases in cs.DECODE_SHAPES:
        q, k, v = _decode_inputs(B, S, K, G, hd, dt, S + G)
        for pos, window in cases:
            got = DK.decode_attention_cuda(q, k, v, pos, window)
            want = DR.decode_attention_ref(q, k, v, pos, window)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol, msg=lambda m: f"{path} "
                                       f"pos {pos} window {window}: {m}")
    for path, B, S, K, G, hd, cases in cs.DECODE_CUT:
        q, k, v = _decode_inputs(B, S, K, G, hd, dt, S + K)
        for pos, window in cases:
            got = DK.decode_attention_cuda(q, k, v, pos, window)
            want = DR.decode_attention_ref(q, k, v, pos, window)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            del want
            for R_ in cs.DECODE_CUT_RANKS:
                n = S // R_
                for r in range(R_):
                    kb, vb = (x[:, r * n:(r + 1) * n].contiguous()
                              for x in (k, v))
                    part = DK.decode_attention_partial_cuda(
                        q, kb, vb, pos, window, r * n)
                    plain = DR.decode_attention_partial_ref(
                        q, kb, vb, pos, window, r * n)
                    for g, w in zip(part, plain):
                        torch.testing.assert_close(
                            g, w, rtol=cs.PARTIAL_TOL, atol=cs.PARTIAL_TOL,
                            msg=lambda m: f"{path} pos {pos} R {R_} block "
                            f"{r}: {m}")
        del q, k, v
        torch.cuda.empty_cache()


# (B, S, K, G, hd, pos, window, partial): plans of one split and of many
# (more than 8), both modes
DECODE_REPEAT_CASES = [
    (4, 1064, 16, 2, 128, 1054, 1024, False),
    (2, 280, 1, 8, 256, 279, 0, False),
    (1, 8192, 2, 4, 80, 8000, 0, False),
    (4, 2048, 8, 4, 128, 2047, 0, True),
    (1, 4096, 1, 1, 128, 4095, 0, True),
    (2, 37, 2, 2, 16, 36, 0, False)]


def _decode_call(partial, q, k, v, pos, window):
    from repro_torch.kernels.decode_attention import kernel as DK
    if partial:
        return DK.decode_attention_partial_cuda(q, k, v, pos, window, 0)
    return (DK.decode_attention_cuda(q, k, v, pos, window),)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,K,G,hd,pos,window,partial",
                         DECODE_REPEAT_CASES)
def test_decode_attention_is_bit_equal_run_to_run(B, S, K, G, hd, pos,
                                                  window, partial):
    """Two calls give the same bits: the warps and then the splits are
    merged in a fixed order, whichever split arrives last."""
    _need_cuda()
    q, k, v = _decode_inputs(B, S, K, G, hd, torch.bfloat16, S + pos)
    first = _decode_call(partial, q, k, v, pos, window)
    for _ in range(3):
        again = _decode_call(partial, q, k, v, pos, window)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,K,G,hd,pos,window,partial",
                         DECODE_REPEAT_CASES)
def test_decode_attention_graph_replays_match_eager(B, S, K, G, hd, pos,
                                                    window, partial):
    """Three launches captured in one CUDA graph, replayed three times in
    a row, equal the eager call bit for bit.  The capture's counters are
    zeroed once, at its first launch: the second and third launches pass
    only if every launch leaves its counters at 0."""
    _need_cuda()
    from repro_torch.kernels.decode_attention import kernel as DK
    q, k, v = _decode_inputs(B, S, K, G, hd, torch.bfloat16, S + pos + 1)
    want = _decode_call(partial, q, k, v, pos, window)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):               # the counters, eagerly
        _decode_call(partial, q, k, v, pos, window)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = DK.LAUNCHES
    with torch.cuda.graph(graph, stream=stream):
        outs = [_decode_call(partial, q, k, v, pos, window)
                for _ in range(3)]
    assert DK.LAUNCHES == before + 3
    for _ in range(3):
        for out in outs:
            for x in out:
                x.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for out in outs:
            assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
def test_decode_attention_graphs_on_one_stream_replay_in_any_order():
    """Two graphs captured on torch's shared capture stream (as
    chip_smoke's ``_graph_ms`` captures, after a warm-up on a side
    stream), the second with more groups than the first, then eager calls
    that outgrow the stream's workspace: replayed second first, then
    first, twice, each graph's outputs equal the eager call bit for bit.
    Each capture has counters of its own, zeroed by its own graph, and no
    graph holds a workspace that eager launches replace."""
    _need_cuda()
    cases = [(1, 4096, 1, 1, 128, 4095, 0, False),
             (4, 2048, 8, 4, 128, 2047, 0, True)]
    ins = [_decode_inputs(B, S, K, G, hd, torch.bfloat16, S + pos)
           for B, S, K, G, hd, pos, window, partial in cases]
    wants = [_decode_call(c[7], *x, c[5], c[6]) for c, x in zip(cases, ins)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c, x in zip(cases, ins):
            _decode_call(c[7], *x, c[5], c[6])
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    for c, x in zip(cases, ins):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append([_decode_call(c[7], *x, c[5], c[6])
                         for _ in range(2)])
        graphs.append(graph)
    # 33 groups of 8 query rows over 8 splits: 4x the scratch of cases
    big = _decode_inputs(1, 4096, 33, 8, 128, torch.bfloat16, 7)
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            _decode_call(False, *big, 4095, 0)
    torch.cuda.synchronize()
    for _ in range(2):
        for i in (1, 0):
            for out in outs[i]:
                for x in out:
                    x.fill_(float("nan"))
            graphs[i].replay()
            torch.cuda.synchronize()
            for out in outs[i]:
                assert all(torch.equal(a, b) for a, b in zip(out, wants[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_partial_masked_block_over_many_splits_on_card(dtype):
    """A block with no valid position whose uniform pass runs over many
    splits (jamba's rank block, 2,048 positions, and a 1-group block of
    8,192): m = -2**30 and l the block's length exactly, o the mean of its
    values within 2e-5, as the plain partial."""
    _need_cuda()
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    dt = getattr(torch, dtype)
    for B, S, K, G, hd, offset, pos in ((4, 2048, 8, 4, 128, 6144, 1030),
                                        (1, 8192, 1, 2, 80, 8192, 100)):
        q, k, v = _decode_inputs(B, S, K, G, hd, dt, S + offset)
        splits, _ = DK.launch_plan(q.device, dt, B, K, G, hd, S)
        assert splits > 1
        o, m, l = DK.decode_attention_partial_cuda(q, k, v, pos, 0, offset)
        want = DR.decode_attention_partial_ref(q, k, v, pos, 0, offset)
        torch.cuda.synchronize()
        assert bool((m == DR.NEG_INF).all()) and bool((l == S).all())
        torch.testing.assert_close(o, want[0], rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(
            o, v.float().mean(dim=1)[:, :, None, :].expand_as(o),
            rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_decode_plan_passes_the_cluster_size_on_card():
    """The plan takes more than 8 splits where few groups hold many
    positions (no cluster cap), and one split where the groups alone
    fill the card."""
    _need_cuda()
    from repro_torch.kernels.decode_attention import kernel as DK
    dev = torch.device("cuda")
    assert DK.launch_plan(dev, torch.bfloat16, 1, 1, 1, 128, 4096)[0] > 8
    assert DK.launch_plan(dev, torch.bfloat16, 1, 2, 4, 80, 8001)[0] > 8
    assert DK.launch_plan(dev, torch.bfloat16, 64, 64, 1, 128, 4096)[0] \
        == 1


# ------------------------------------------- the decode kernel's partial mode
# (B, S, K, G, hd, block, offset, pos, window): one block of a cut cache,
# fully valid, partly valid (pos inside; a window cutting its start),
# fully masked (pos before it; a window ending before it), and a block
# that holds no valid position where another does; jamba's rank block
# (B 4, 2,048 of 8,192, K 8, G 4) and gemma3's (K 16, G 2, window 1,024)
PARTIAL_CASES = [
    (2, 256, 2, 2, 64, 64, 64, 200, 0), (2, 256, 2, 2, 64, 64, 128, 150, 0),
    (2, 256, 2, 2, 64, 64, 0, 150, 0), (2, 256, 2, 2, 64, 64, 192, 150, 0),
    (1, 300, 2, 8, 80, 100, 100, 160, 40), (1, 300, 2, 8, 80, 100, 0, 160, 40),
    (1, 37, 1, 3, 37, 20, 17, 36, 7),
    (4, 8192, 8, 4, 128, 2048, 0, 1030, 0),
    (4, 8192, 8, 4, 128, 2048, 2048, 1030, 0),
    (4, 8192, 8, 4, 128, 2048, 4096, 4106, 0),
    (4, 32768, 16, 2, 128, 8192, 8192, 9000, 1024),
    (4, 32768, 16, 2, 128, 8192, 0, 9000, 1024)]


def _partial_inputs(B, S, K, G, hd, dt, seed):
    """Seeded q, k, v drawn on the card (a host draw of a 32,768-deep
    cache takes seconds)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dt)
                 for s in ((B, K, G, hd), (B, S, K, hd), (B, S, K, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,G,hd,block,offset,pos,window",
                         PARTIAL_CASES)
def test_decode_partial_kernel_matches_plain_on_card(dtype, B, S, K, G, hd,
                                                     block, offset, pos,
                                                     window):
    """The kernel's partial mode on one block of a cache (one launch)
    against the plain partial on the same block: o, m and l within 2e-5
    (float32 outputs in both dtypes: the same float32 sums in another
    order, m through base 2); a block with no valid position reports m
    = -2**30 and l its length exactly."""
    _need_cuda()
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    dt = getattr(torch, dtype)
    q, k, v = _partial_inputs(B, S, K, G, hd, dt, S + offset + pos)
    kb, vb = (x[:, offset:offset + block].contiguous() for x in (k, v))
    before = DK.LAUNCHES
    got = DK.decode_attention_partial_cuda(q, kb, vb, pos, window, offset)
    want = DR.decode_attention_partial_ref(q, kb, vb, pos, window, offset)
    torch.cuda.synchronize()
    assert DK.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)
    t = np.arange(offset, offset + block)
    if not ((t <= pos) & ((t > pos - window) if window else True)).any():
        assert bool((got[1] == DR.NEG_INF).all())
        assert bool((got[2] == block).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R_", [2, 4, 8])
@pytest.mark.parametrize("pos,window", [(9000, 1024), (20000, 0), (-1, 0)])
def test_decode_partials_merged_match_whole_cache_on_card(dtype, R_, pos,
                                                          window):
    """``merge_partials`` of R blocks' kernel partials (gemma3's cache, B
    4, S 32,768, K 16, G 2) equals the whole-cache kernel and the plain
    version within 2e-5 (float32) / 3e-2 (bfloat16), the decode kernel's
    tolerances, with no valid position anywhere among the cases."""
    _need_cuda()
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    dt = getattr(torch, dtype)
    q, k, v = _partial_inputs(4, 32768, 16, 2, 128, dt, R_ + pos + 1)
    n = 32768 // R_
    parts = [DK.decode_attention_partial_cuda(
        q, k[:, r * n:(r + 1) * n].contiguous(),
        v[:, r * n:(r + 1) * n].contiguous(), pos, window, r * n)
        for r in range(R_)]
    got = DR.merge_partials(*(torch.stack(x) for x in zip(*parts)),
                            dtype=dt)
    whole = DK.decode_attention_cuda(q, k, v, pos, window)
    plain = DR.decode_attention_ref(q, k, v, pos, window)
    torch.cuda.synchronize()
    tol = 3e-2 if dt == torch.bfloat16 else 2e-5
    for want in (whole, plain):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


# ---------------------------------------------------- sharded, across cards
def _need_cards(n):
    _need_cuda()
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices (one NCCL rank per card)")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape", [("jamba-v0.1-52b", (1, 2)),
                                        ("gemma3-27b", (1, 2)),
                                        ("jamba-v0.1-52b", (2, 2))])
def test_sharded_decode_across_cards_matches_cpu(tmp_path, arch, shape):
    """A prefill and three decode steps of a reduced model over a (1, 2)
    mesh of two NCCL ranks, one card each (the cache's sequence cut over
    "model": the kernel's partial mode on each card, the all-gather of
    (o, m, l) over NCCL, ``merge_partials``; jamba's ``moe_ep`` over ep 2
    and its SSM layers), or a (2, 2) mesh of four (the batch cut over
    "data" as well, so ``local_map``'s groups are those of each mesh
    dim), against the same run on as many CPU gloo ranks (the plain
    partial): every logit within 1e-4 (float32, no TF32; the reduced
    models' card-vs-CPU tolerance), and the kernel launched once per
    attention layer per decode step on each card.  Needs a card a
    rank."""
    n = shape[0] * shape[1]
    _need_cards(n)
    from repro_torch.configs import get_config
    from repro_torch.launch import local
    from repro_torch.launch.mesh import spawn_local
    cfg = get_config(arch).reduced()
    positions = [16, 17, 8]
    local.decode_inputs(str(tmp_path), cfg, positions)
    got = {}
    for dev, backend in (("cuda", "cpu:gloo,cuda:nccl"), ("cpu", "gloo")):
        out = tmp_path / dev
        out.mkdir()
        spawn_local(local.sharded_decode_rank, n,
                    [(arch, cfg, str(tmp_path))], shape,
                    ("data", "model"), str(out), dev, timeout=300,
                    backend=backend)
        got[dev] = [np.load(out / f"rank{r}.npz") for r in range(n)]
    attn = sum(s.kind == "attn" for s in cfg.layer_plan())
    for c, p in zip(got["cuda"], got["cpu"]):
        assert int(c[f"{arch}/launches"]) == attn * len(positions)
        assert np.isfinite(c[f"{arch}/logits"]).all()
        np.testing.assert_allclose(c[f"{arch}/logits"], p[f"{arch}/logits"],
                                   rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_sharded_train_tp_ep_across_cards_matches_cpu(tmp_path):
    """``make_train_step`` over a (1, 2) mesh of two NCCL ranks, one card
    each (reduced OLMoE at capacity factor 1.0: TP over "model" and
    ``moe_ep`` over ep 2, pairs dropped), against the same two steps on
    two CPU gloo ranks from one step-0 checkpoint: the losses within
    1e-5, the grad norms within rtol 1e-4, every first-step gradient
    within atol 1e-5 + rtol 1e-3 and each parameter's update within
    1e-3 of the CPU's in the L2 norm (tests/test_torch_sharded.py's
    bounds).  Needs two cards."""
    _need_cards(2)
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import local
    from repro_torch.launch.mesh import spawn_local
    from repro_torch.models import model as TM
    from repro_torch.optim import AdamWConfig, make_train_state
    cfg = get_config("olmoe-1b-7b").reduced(capacity_factor=1.0)
    opt = AdamWConfig(lr=1e-2, warmup_steps=2)
    dcfg = DataConfig(256, 32, 4, 0)
    state0 = make_train_state(TM.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), opt)
    CheckpointManager(str(tmp_path / "ckpt")).save(0, state0)
    got = {}
    for dev, backend in (("cuda", "cpu:gloo,cuda:nccl"), ("cpu", "gloo")):
        out = tmp_path / dev
        out.mkdir()
        spawn_local(local.sharded_train_rank, 2, cfg, dcfg, opt, (1, 2),
                    ("data", "model"), 2, str(tmp_path / "ckpt"), str(out),
                    dev, timeout=300, backend=backend)
        got[dev] = [np.load(out / f"rank{r}.npz") for r in range(2)]
    card, cpu = got["cuda"][0], got["cpu"][0]
    for g in got["cuda"]:
        assert g["blocks"].size == 0
        np.testing.assert_array_equal(g["losses"], card["losses"])
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(card["grad_norms"], cpu["grad_norms"],
                               rtol=1e-4)
    for k in (k for k in cpu.files if k.startswith("g[")):
        np.testing.assert_allclose(card[k], cpu[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    from repro_torch.tree import walk
    for key, _, a in walk(state0["params"]):
        want = cpu[f"p{key}"] - a.numpy()
        err = np.linalg.norm(card[f"p{key}"] - a.numpy() - want)
        assert err <= 1e-3 * max(np.linalg.norm(want), 1e-12), (key, err)


FULL_SERVE = dict(batch=4, prompt_len=1024, max_len=8192, steps=32)


@pytest.mark.cuda
def test_jamba_full_width_serves_across_four_cards(tmp_path):
    """jamba-v0.1-52b at its published widths (bfloat16, random weights,
    each rank drawing its own blocks) over a (1, 4) mesh of four NCCL
    ranks, one card each: a prefill of 4 prompts of 1,024 tokens into an
    8,192-deep cache cut 2,048 positions a rank over "model", 32 greedy
    decode steps (every decode position in rank 0's block: rank 0 partly
    valid, ranks 1-3 fully masked) and one at position 4,106 (ranks 0-1
    fully valid, rank 2 partly, rank 3 masked).  Every rank gives the
    same finite logits; the decode kernel runs 4 times a step (its 4
    attention layers, partial mode), the router 16 times a prefill or
    step (``moe_ep`` over ep 4), the SSD scan 28 times a prefill.  The
    first two decode steps, rerun from the caches they read: by the
    kernel route they give the run's logits, and each of their attention
    calls is within 3e-2 of the plain partial route's on the same inputs
    (the decode kernel's bfloat16 tolerance, scaled by the output's
    largest value above 1).  By the plain partial route, every checked
    step's batch rows whose ``moe_ep`` routing is the kernel route's on
    every rank give logits within 3e-2 of the kernel route's, scaled
    likewise; every step holds at least one row, and more than half of
    all the steps' rows are held.  The top-2 choice is discrete, so an
    attention output a bfloat16 step apart can flip a near tie and
    change that token's whole output; the rows that flipped are in the
    record.  The rank function is ``tests/torch_serve_check.py``'s.  The
    readings go to ``chiprun_out/jamba_sharded_serve.json``, written
    before the checks.  Needs four cards."""
    _need_cards(4)
    import json
    import os
    import time
    from repro_torch.launch.mesh import spawn_local
    from torch_serve_check import serve_check_rank
    out = tmp_path / "out"
    out.mkdir()
    t0 = time.perf_counter()
    spawn_local(serve_check_rank, 4, "jamba-v0.1-52b", (1, 4),
                ("data", "model"), str(out), FULL_SERVE["batch"],
                FULL_SERVE["prompt_len"], FULL_SERVE["max_len"],
                FULL_SERVE["steps"], timeout=900,
                backend="cpu:gloo,cuda:nccl")
    wall_s = time.perf_counter() - t0
    ranks = [np.load(out / f"rank{r}.npz") for r in range(4)]
    steps = FULL_SERVE["steps"] + 1
    r0 = ranks[0]

    def scaled_err(a, b):
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
    flipped = np.any([g["flipped"] for g in ranks], axis=0)  # (2, B)
    held = [np.flatnonzero(~f) for f in flipped]
    dec = [g["decode_ms"][1:FULL_SERVE["steps"]] for g in ranks]
    errs = {"attn_scaled": max(float((g["attn_err"] / np.maximum(
                1.0, g["attn_scale"])).max()) for g in ranks),
            "attn_abs": max(float(g["attn_err"].max()) for g in ranks),
            "logits_rerun_scaled": max(scaled_err(
                g["check_kernel"], g["logits"][:, 1:3]) for g in ranks),
            "logits_routes_scaled": [max(scaled_err(
                g["check_plain"][rows, i], g["check_kernel"][rows, i])
                for g in ranks) if len(rows) else None
                for i, rows in enumerate(held)],
            "logits_routes_abs_all_rows": max(float(np.abs(
                g["check_plain"] - g["check_kernel"]).max()) for g in ranks),
            "flipped_rows": [np.flatnonzero(f).tolist() for f in flipped]}
    rec = {"card": torch.cuda.get_device_name(0), "cards": 4,
           "wall_s": wall_s,
           "prefill_ms": [float(g["prefill_ms"]) for g in ranks],
           "prefill_cold_ms": [float(g["prefill_cold_ms"]) for g in ranks],
           "decode_ms_p50": [float(np.percentile(d, 50)) for d in dec],
           "decode_ms_p95": [float(np.percentile(d, 95)) for d in dec],
           "first_step_ms": [float(g["decode_ms"][0]) for g in ranks],
           "extra_step_ms": [float(g["decode_ms"][-1]) for g in ranks],
           "init_s": [float(g["init_s"]) for g in ranks],
           "init_peak_gb": [int(g["init_peak_bytes"]) / 1e9 for g in ranks],
           "peak_gb": [int(g["peak_bytes"]) / 1e9 for g in ranks],
           "dropped_share": sum(int(g["dropped"]) for g in ranks)
           / max(1, sum(int(g["pairs"]) for g in ranks)),
           "errors": errs,
           "launches": {k[len("launches_"):]: int(r0[k]) for k in r0.files
                        if k.startswith("launches_")}}
    root = pathlib.Path(__file__).resolve().parents[1] / "chiprun_out"
    root.mkdir(exist_ok=True)
    tmp = root / "jamba_sharded_serve.json.tmp"
    tmp.write_text(json.dumps(rec, indent=1))
    os.replace(tmp, root / "jamba_sharded_serve.json")
    print(json.dumps(rec))
    assert r0["logits"].shape == (4, steps + 1, 65536)
    assert np.isfinite(r0["logits"]).all()
    assert int(r0["extra_pos"]) == 4106
    for g in ranks:
        np.testing.assert_array_equal(g["logits"], r0["logits"])
        assert int(g["launches_decode_decode_attention"]) == 4 * steps
        assert int(g["launches_prefill_decode_attention"]) == 0
        assert int(g["launches_prefill_moe_route"]) == 16
        assert int(g["launches_decode_moe_route"]) == 16 * steps
        assert int(g["launches_prefill_ssd_scan"]) == 28
        assert int(g["launches_decode_ssd_scan"]) == 0
        assert g["attn_err"].shape == (4 * 2,)
        assert int(g["peak_bytes"]) < torch.cuda.get_device_properties(
            0).total_memory
    assert errs["attn_scaled"] <= 3e-2
    assert errs["logits_rerun_scaled"] <= 3e-2
    assert all(len(rows) for rows in held)
    assert sum(len(rows) for rows in held) > flipped.size / 2
    assert max(errs["logits_routes_scaled"]) <= 3e-2
