"""Parity of the port's clearing pass (``repro_torch.kernels.market_clear``)
with the JAX reference ``repro.kernels.market_clear.ops.clear``.

The same sorted books, built from numpy-seeded inputs, go through the
reference's jnp path and the port's CPU path; all five outputs must be
equal element for element (the pass is comparisons and max only, so no
tolerance).  One case also holds the port against the reference's
Pallas kernel in interpret mode.  The CUDA kernel is held to the plain
version in tests/test_torch_cuda.py.
"""
import gc
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.kernels.market_clear.ops import clear as jax_clear
from repro_torch.kernels.market_clear import ops as tops
from repro_torch.kernels.market_clear import ref as tref
from repro_torch.market_torch.engine import BatchEngine, TreeSpec, \
    build_tree

NAMES = ("rate", "best_level", "cand_slots", "truncated", "evict")
# small tensors: one thread, so the port's ops do not contend with the
# reference's compiler threads in parallel test workers
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends.  Each holds
    memory mappings; a test worker that gathers more than the kernel's
    ``vm.max_map_count`` (65,530) crashes in a later XLA compile."""
    yield
    jax.clear_caches()
    gc.collect()


def _tree(shape):
    if shape == "n24-nonpow2":
        return TreeSpec(24, (1, 4, 12, 24))     # non-power-of-two strides
    if shape == "n64-deep":
        return TreeSpec(64, (1, 1, 2, 4, 64))   # stride-1 level above 0
    return build_tree(int(shape.lstrip("n")))


def _clear_args(eng, st):
    return (st["order"], st["sorted_gseg"], st["seg_start"], st["price"],
            st["tenant"], st["seq"], tuple(st["floor"]), eng.level_off,
            eng.tree.strides, st["owner"], st["limit"], eng.k)


def _np_args(args):
    return tuple(tuple(np.asarray(f) for f in a) if isinstance(a, tuple)
                 and a and isinstance(a[0], torch.Tensor)
                 else (a.numpy() if isinstance(a, torch.Tensor) else a)
                 for a in args)


def _jax_args(args):
    return tuple(tuple(jnp.asarray(f) for f in a) if isinstance(a, tuple)
                 and a and isinstance(a[0], np.ndarray)
                 else (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
                 for a in _np_args(args))


def _assert_matches_reference(eng, st, health=None, use_pallas=False):
    args = _clear_args(eng, st)
    port = tops.clear(*args, health=health)
    jh = None if health is None else jnp.asarray(health.numpy())
    kw = dict(use_pallas=True, interpret=True) if use_pallas else {}
    ref = jax_clear(*_jax_args(args), health=jh, **kw)
    for name, a, b in zip(NAMES, ref, port):
        assert b.dtype == (torch.float32 if name == "rate" else torch.int32)
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    return port


def _random_book(tree, k, seed, n_bids=700, n_ten=9):
    rng = np.random.default_rng(seed)
    eng = BatchEngine(tree, capacity=4096, k=k, device="cpu")
    st = eng.init_state()
    st["floor"][-1] = torch.tensor([1.5], dtype=torch.float32)
    levels = rng.integers(0, tree.n_levels, n_bids).astype(np.int32)
    nodes = np.array([rng.integers(0, tree.nodes_at(d)) for d in levels],
                     np.int32)
    prices = rng.uniform(1, 9, n_bids).astype(np.float32)
    # a coarse price grid makes equal-price (seq tie-break) cases common
    prices[::3] = np.round(prices[::3])
    tenants = rng.integers(0, n_ten, n_bids).astype(np.int32)
    st = eng.place(st, *map(torch.from_numpy,
                            (prices, levels, nodes, tenants)))
    half = tree.n_leaves // 2
    owner = st["owner"].clone()
    owner[:half] = torch.from_numpy(
        rng.integers(0, n_ten, half).astype(np.int32))
    limit = st["limit"].clone()
    limit[:half] = torch.from_numpy(
        rng.uniform(2, 8, half).astype(np.float32))
    st["owner"], st["limit"] = owner, limit
    return eng, st


# every tree and every K twice, without the full product: each distinct
# (tree, K) costs the reference one compile
@pytest.mark.parametrize("shape,k", [
    ("n512", 1), ("n512", 8), ("n768", 4), ("n768", 16),
    ("n1024", 1), ("n1024", 16), ("n24-nonpow2", 4), ("n24-nonpow2", 8)])
def test_clear_matches_reference(shape, k):
    eng, st = _random_book(_tree(shape), k, seed=k * 7 + len(shape))
    _assert_matches_reference(eng, st)


def test_clear_skips_killed_entries():
    """A view made stale by kills (cancels) still clears identically."""
    eng, st = _random_book(build_tree(512), 4, seed=11)
    rng = np.random.default_rng(12)
    st = eng.cancel(st, torch.from_numpy(
        rng.integers(0, 700, 300).astype(np.int32)))
    _assert_matches_reference(eng, st)


def test_clear_lap_reused_seq_ties():
    """Equal-price bids in slots reused after a ring lap (slot order
    inverts arrival order) rank by seq on both sides."""
    tree = build_tree(64)
    eng = BatchEngine(tree, capacity=8, k=4, device="cpu")
    st = eng.init_state()
    root = tree.n_levels - 1

    def bids(price, tenants):
        m = len(tenants)
        return (torch.full((m,), price, dtype=torch.float32),
                torch.full((m,), root, dtype=torch.int32),
                torch.zeros((m,), dtype=torch.int32),
                torch.tensor(tenants, dtype=torch.int32))
    st = eng.place(st, *bids(5.0, list(range(8))))
    st = eng.cancel(st, torch.tensor([5], dtype=torch.int32))
    st = eng.place(st, *bids(5.0, [8]))          # A -> reused slot 5
    st = eng.cancel(st, torch.tensor([2], dtype=torch.int32))
    st = eng.place(st, *bids(5.0, [9]))          # B -> earlier slot 2
    seq = st["seq"].numpy()
    assert seq[2] > seq[5] > seq[7]
    port = _assert_matches_reference(eng, st)
    live = [s for s in port[2][0].tolist() if s >= 0]
    assert list(seq[live]) == sorted(seq[live])


def test_clear_truncated_slates():
    """A node book deeper than K truncates the slate (flag set)."""
    tree = build_tree(512)
    eng = BatchEngine(tree, capacity=4096, k=2, device="cpu")
    st = eng.init_state()
    rng = np.random.default_rng(5)
    m = 40
    st = eng.place(st, torch.from_numpy(
        rng.uniform(3, 9, m).astype(np.float32)),
        torch.ones(m, dtype=torch.int32), torch.zeros(m, dtype=torch.int32),
        torch.arange(m, dtype=torch.int32))
    port = _assert_matches_reference(eng, st)
    trunc = port[3].numpy()
    assert trunc[: tree.strides[1]].all()
    assert not trunc[tree.strides[1]:].any()


def test_clear_health_mask():
    """Draining and down leaves get all-hole slates and floor-only
    rates after either version of the pass."""
    eng, st = _random_book(build_tree(768), 8, seed=29)
    rng = np.random.default_rng(22)
    health = torch.from_numpy(
        rng.choice([0, 0, 1, 2], eng.tree.n_leaves).astype(np.int32))
    port = _assert_matches_reference(eng, st, health=health)
    bad = health.numpy() != tref.HEALTH_UP
    assert (port[2].numpy()[bad] == -1).all()


def test_clear_matches_pallas_interpret():
    """The port against the reference's Pallas kernel (interpret mode)."""
    eng, st = _random_book(_tree("n24-nonpow2"), 4, seed=31, n_bids=120)
    _assert_matches_reference(eng, st, use_pallas=True)


def test_sort_book_ties_zero_signs_like_lax_sort():
    """lax.sort canonicalizes -0.0 to +0.0: the zeros tie and seq breaks
    the tie.  The port's sort key must agree."""
    gseg = torch.zeros(4, dtype=torch.int32)
    prices = torch.tensor([0.0, -0.0, 0.0, -0.0])
    seqs = torch.tensor([3, 2, 1, 0], dtype=torch.int32)
    order, _ = tref.sort_book(gseg, prices, seqs)
    assert order.tolist() == [3, 2, 1, 0]


# ------------------------------------------------------------------
# The CUDA kernel's design, held on the CPU: its leaf-range plan, its
# rank-by-count merge and its dead-node skip, mirrored in numpy.
# ------------------------------------------------------------------
from repro_torch.kernels.market_clear import kernel as tkern  # noqa: E402

F32 = np.float32
NEG32 = F32(tref.NEG)
HALF_NEG32 = F32(tref.NEG / 2)
PLAN_TREES = ("n10000", "n768", "n24-nonpow2", "n64-deep")


def _ancestors(strides, n_leaves):
    """(n_leaves, n_lvl) ancestor of every leaf by the reference's parent
    map (ref.clear_sorted_from_aggs): leaf // stride[0], then
    parent = node * stride[d] // stride[d+1] level by level."""
    nodes = [np.arange(n_leaves) // strides[0]]
    for d in range(len(strides) - 1):
        nd = -(-n_leaves // strides[d])
        parent = (np.arange(nd) * strides[d]) // strides[d + 1]
        nodes.append(parent[nodes[-1]])
    return np.stack(nodes, axis=1)


@pytest.mark.parametrize("shape", PLAN_TREES)
@pytest.mark.parametrize("per_block", [32, 64, 7, 1])
def test_leaf_plan_matches_reference_parent_map(shape, per_block):
    """Each block's per-level node range is exactly the set of its
    leaves' ancestors, and its staging offsets are the counts below."""
    tree = _tree(shape)
    plan = tkern.leaf_plan(tree.strides, tree.n_leaves, per_block)
    anc = _ancestors(tree.strides, tree.n_leaves)
    n_blocks = -(-tree.n_leaves // per_block)
    assert plan.shape == (n_blocks, 3, tree.n_levels)
    for b in range(n_blocks):
        lo, cnt, soff = plan[b]
        rows = anc[b * per_block:(b + 1) * per_block]
        for d in range(tree.n_levels):
            assert set(rows[:, d]) == set(range(lo[d], lo[d] + cnt[d]))
            assert 0 <= lo[d] and lo[d] + cnt[d] <= tree.nodes_at(d)
        assert list(soff) == list(np.cumsum(cnt) - cnt)
    max_hi, own_max = tkern.plan_sizes(plan)
    assert own_max == plan[:, 1].sum(axis=1).max()
    assert max_hi == plan[:, 1, 1:].max()
    if shape == "n10000" and per_block == tkern.LEAVES_PER_BLOCK:
        assert n_blocks >= 2 * 132          # two blocks an H100 SM


def _better(p1, q1, p2, q2):
    return p1 > p2 or (p1 == p2 and q1 < q2)


def _rank_merge(A, a2, B, b2, k):
    """The kernel's `merge_into` for one row, in numpy: an entry's output
    rank is the count of distinct live (price, seq) keys strictly better
    than its own; equal keys collapse into one output with the group's
    largest tenant, slot and level; a NaN anywhere kills every rank; a
    zero price takes the bits of the highest-index remaining entry equal
    to it; the fall-back as `_merge2`."""
    P = np.concatenate([A[0], B[0]]).astype(F32)
    T, S, Q, L = (np.concatenate([a, b]) for a, b in zip(A[1:], B[1:]))
    n = 2 * k
    live = np.zeros(n, bool) if np.isnan(P).any() else P > HALF_NEG32
    lead = [live[e] and not any(live[j] and P[j] == P[e] and Q[j] == Q[e]
                                for j in range(e)) for e in range(n)]
    out = [np.full(k, NEG32, F32)] + [np.full(k, -1, np.int32)
                                       for _ in range(4)]
    for e in range(n):
        if not live[e]:
            continue
        r = sum(lead[j] and _better(P[j], Q[j], P[e], Q[e])
                for j in range(n))
        if r >= k:
            continue
        pout = P[e]
        if P[e] == 0:
            for j in range(n):
                if live[j] and P[j] == 0 and Q[j] >= Q[e]:
                    pout = P[j]
        for f, v in ((1, T[e]), (2, S[e]), (4, L[e])):
            out[f][r] = max(out[f][r], v)
        if lead[e]:
            out[0][r], out[3][r] = pout, Q[e]
    t0 = out[1][0]
    head_a = tuple(x[0] for x in A)
    head_b = tuple(x[0] for x in B)
    cA = a2 if A[1][0] == t0 else head_a
    cB = b2 if B[1][0] == t0 else head_b
    a_wins = cA[0] > cB[0] or (cA[0] == cB[0] and cA[3] < cB[3])
    return tuple(out), (cA if a_wins else cB)


def _same_bits(a, b):
    return F32(a[0]).view(np.int32) == F32(b[0]).view(np.int32) and \
        all(int(x) == int(y) for x, y in zip(a[1:], b[1:]))


def _merge_is_identity(A, a2, B, b2, k):
    """The kernel's `merge_is_identity`: merging this dead B into A
    keeps A and its fall-back."""
    P = np.asarray(A[0], F32)
    if not (np.asarray(B[0], F32) <= HALF_NEG32).all():
        return False                    # B live, or a NaN in it
    live = P > HALF_NEG32
    m = int(live.sum())
    if not live[:m].all():
        return False                    # live entries are not a prefix
    for j in range(m):
        if min(A[1][j], A[2][j], A[4][j]) < -1:
            return False
        if j + 1 < m and not _better(P[j], A[3][j], P[j + 1], A[3][j + 1]):
            return False
    for j in range(m, k):
        if not _same_bits(tuple(x[j] for x in A), (NEG32, -1, -1, -1, -1)):
            return False
    zeros = P[:m][P[:m] == 0]
    if len(set(np.signbit(zeros))) > 1:
        return False
    t0 = A[1][0] if m else -1
    cB = b2 if B[1][0] == t0 else tuple(x[0] for x in B)
    return bool(a2[0] > cB[0] or (a2[0] == cB[0] and a2[3] < cB[3])
                or _same_bits(a2, cB))


def _node_path(A, a2, B, b2, k):
    """The kernel's `node_path`: the parent's path when merging is the
    identity, else the merge."""
    if _merge_is_identity(A, a2, B, b2, k):
        return A, a2
    return _rank_merge(A, a2, B, b2, k)


def _serial_merge(A, a2, B, b2, k):
    """The k-pass selection one thread ran before the redesign, line for
    line: the order of its NaN-propagating max fold sets the sign of a
    zero output price."""
    W = list(np.concatenate([A[0], B[0]]).astype(F32))
    Q = list(np.concatenate([A[3], B[3]]))
    ent = [tuple(x[j] for x in A) for j in range(k)] + \
        [tuple(x[j] for x in B) for j in range(k)]
    out = [np.full(k, NEG32, F32)] + [np.full(k, -1, np.int32)
                                       for _ in range(4)]
    for r in range(k):
        pm = W[0]
        for j in range(1, 2 * k):
            pm = F32(np.nan) if np.isnan(pm) or np.isnan(W[j]) else (
                pm if pm > W[j] else W[j])
        cand = [W[j] > HALF_NEG32 and W[j] >= pm for j in range(2 * k)]
        qm = min([Q[j] for j in range(2 * k) if cand[j]],
                 default=tref.BIGS)
        mt = ms = ml = -1
        for j in range(2 * k):
            if cand[j] and Q[j] == qm:
                mt, ms, ml = (max(mt, ent[j][1]), max(ms, ent[j][2]),
                              max(ml, ent[j][4]))
                W[j] = NEG32
        alive = pm > HALF_NEG32
        out[0][r] = pm if alive else NEG32
        out[3][r] = qm if alive else -1
        out[1][r], out[2][r], out[4][r] = mt, ms, ml
    return _rank_merge(A, a2, B, b2, k)[1], out


def _random_side(rng, k, mode):
    """One ranked side (p, t, s, q, l) of k entries and a fall-back.
    ``canonical``: strictly ordered live prefix, exact dead tail;
    ``ties``: few prices and seqs, so equal (price, seq) pairs (seqs
    reused after a ring lap) and equal prices occur, unsorted, with
    ±0.0; ``dead``: every entry dead."""
    live = rng.integers(0, k + 1)
    if mode == "dead":
        live = 0
    if mode == "ties":
        p = rng.choice(F32([3, 2, 1, 0, -0.0, 2]), k)
        q = rng.integers(0, 4, k)
    else:
        p = np.sort(rng.choice(F32([9, 7, 5, 4, 2, 1, 0.5, 0]), k))[::-1]
        q = rng.permutation(4 * k)[:k]
        q[:live] = np.sort(q[:live])
    p = p.astype(F32)
    t = rng.integers(0, 5, k)
    s = rng.integers(0, 50, k)
    lv = rng.integers(0, 4, k)
    if mode != "ties":
        # live prefix, strictly ordered by (price desc, seq asc)
        order = np.lexsort((q[:live], -p[:live]))
        p[:live], q[:live] = p[:live][order], q[:live][order]
        p[:live] = p[:live] + F32(0.001) * np.arange(live, 0, -1)
        p[live:] = NEG32
        for x in (t, s, q, lv):
            x[live:] = -1
    else:
        dead = rng.random(k) < 0.3
        p[dead] = NEG32
    side = (p, t.astype(np.int32), s.astype(np.int32), q.astype(np.int32),
            lv.astype(np.int32))
    if live and rng.random() < 0.8:
        f = (F32(rng.choice([0.5, 3.0, 6.0])), np.int32(rng.integers(0, 5)),
             np.int32(rng.integers(0, 50)), np.int32(rng.integers(0, 99)),
             np.int32(rng.integers(0, 4)))
    else:
        f = (NEG32, np.int32(-1), np.int32(-1), np.int32(-1), np.int32(-1))
    return side, f


def _rows(k, seed, n=60):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ma = ("canonical", "ties", "dead")[i % 3]
        mb = ("dead", "ties", "canonical", "dead")[i % 4]
        A, a2 = _random_side(rng, k, ma)
        B, b2 = _random_side(rng, k, mb)
        if i % 10 == 7:                       # a NaN price somewhere
            side = A if i % 20 == 7 else B
            side[0][rng.integers(0, k)] = np.nan
        rows.append((A, a2, B, b2))
    return rows


def _ref_merge(rows, k):
    """ref._merge2 over the rows as one batch."""
    def stack(get):
        return tuple(torch.from_numpy(np.stack([get(r)[f] for r in rows]))
                     for f in range(5))

    def stack2(get):
        return tuple(torch.from_numpy(np.array([get(r)[f] for r in rows]))
                     for f in range(5))
    return tref._merge2(stack(lambda r: r[0]), stack2(lambda r: r[1]),
                        stack(lambda r: r[2]), stack2(lambda r: r[3]), k)


def _assert_row_equal(got, want_lists, want_f2, i):
    lists, f2 = got
    for f in range(5):
        a, b = np.asarray(lists[f]), want_lists[f][i].numpy()
        assert np.array_equal(a, b, equal_nan=True), (i, f, a, b)
    for f in range(5):
        a, b = np.asarray(f2[f]), want_f2[f][i].numpy()
        assert np.array_equal(a, b, equal_nan=True), (i, f, a, b)


@pytest.mark.parametrize("k", [1, 16, 32])
def test_rank_merge_mirror_matches_merge2(k):
    """The kernel's rank-by-count merge (and its dead-node skip) equals
    the reference's k-pass `_merge2` on lists with lap-reused seq ties
    (equal price and seq), equal prices, ±0.0, all-dead sides and a NaN
    price (which kills the merged list)."""
    rows = _rows(k, seed=k)
    (mP, mT, mS, mQ, mL), m2 = _ref_merge(rows, k)
    seen = {"nan": 0, "tie": 0, "dead_side": 0, "skipped": 0}
    for i, (A, a2, B, b2) in enumerate(rows):
        _assert_row_equal(_rank_merge(A, a2, B, b2, k),
                          (mP, mT, mS, mQ, mL), m2, i)
        _assert_row_equal(_node_path(A, a2, B, b2, k),
                          (mP, mT, mS, mQ, mL), m2, i)
        P = np.concatenate([A[0], B[0]])
        Q = np.concatenate([A[3], B[3]])
        if np.isnan(P).any():
            seen["nan"] += 1
            assert (mP[i] == NEG32).all() and (mT[i] == -1).all()
        keys = [(P[j], Q[j]) for j in range(2 * k) if P[j] > HALF_NEG32]
        seen["tie"] += len(keys) > len(set(keys))
        seen["dead_side"] += bool((B[0] <= HALF_NEG32).all())
        seen["skipped"] += _merge_is_identity(A, a2, B, b2, k)
    assert seen["nan"] and seen["dead_side"] and seen["skipped"]
    assert seen["tie"] or k == 1


@pytest.mark.parametrize("k", [1, 16, 32])
def test_rank_merge_keeps_the_serial_fold_order_of_zeros(k):
    """Bit for bit, sign of zero included, the rank-by-count merge gives
    what the serial k-pass selection gave (its max fold keeps the last of
    equal prices)."""
    rng = np.random.default_rng(100 + k)
    n_zero_rows = 0
    for _ in range(40):
        A, a2 = _random_side(rng, k, "ties")
        B, b2 = _random_side(rng, k, "ties")
        f2, serial = _serial_merge(A, a2, B, b2, k)
        lists, g2 = _rank_merge(A, a2, B, b2, k)
        assert np.array_equal(lists[0].view(np.int32),
                              serial[0].view(np.int32))
        for f in range(1, 5):
            assert np.array_equal(lists[f], serial[f])
        n_zero_rows += bool((serial[0] == 0).any())
    assert n_zero_rows


def _engine_lists(k, seed):
    """Ranked lists as `_prefix_aggregates` makes them from an engine
    book: (segment, k) lists with levels attached, and fall-backs."""
    eng, st = _random_book(build_tree(768), k, seed=seed, n_bids=3000)
    n_seg = st["seg_start"].shape[0] - 1
    pk, tk, sk, qk, p2, t2, s2, q2 = tref._prefix_aggregates(
        st["order"], st["sorted_gseg"], st["seg_start"], st["price"],
        st["tenant"], st["seq"], n_seg, k)
    lvl = torch.where(pk > tref.NEG / 2, 2, -1).to(torch.int32)
    l2 = torch.where(p2 > tref.NEG / 2, 2, -1).to(torch.int32)
    return (pk, tk, sk, qk, lvl), (p2, t2, s2, q2, l2)


@pytest.mark.parametrize("k", [1, 16, 32])
def test_merge2_with_a_dead_side_is_the_identity(k):
    """`_merge2` of a ranked path with an all-dead list returns the path
    and its fall-back unchanged, bit for bit, both for lists as
    `_prefix_aggregates` makes them and for merge outputs; and the
    kernel's check finds every such node skippable."""
    (P, T, S, Q, L), (p2, t2, s2, q2, l2) = _engine_lists(k, seed=40 + k)
    live = P[:, 0] > tref.NEG / 2
    A = tuple(x[live][:64] for x in (P, T, S, Q, L))
    a2 = tuple(x[live][:64] for x in (p2, t2, s2, q2, l2))
    B = tuple(x[live][64:128] for x in (P, T, S, Q, L))
    b2 = tuple(x[live][64:128] for x in (p2, t2, s2, q2, l2))
    merged, m2 = tref._merge2(A, a2, B, b2, k)
    n = A[0].shape[0]
    dead = (torch.full((n, k), tref.NEG),) + tuple(
        torch.full((n, k), -1, dtype=torch.int32) for _ in range(4))
    dead2 = (torch.full((n,), tref.NEG),) + tuple(
        torch.full((n,), -1, dtype=torch.int32) for _ in range(4))
    for path, f2 in ((A, a2), (merged, m2)):
        out, o2 = tref._merge2(path, f2, dead, dead2, k)
        for x, y in zip(out + o2, path + f2):
            assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                               else x,
                               y.view(torch.int32) if y.is_floating_point()
                               else y)
        for i in range(n):
            row = lambda s: tuple(x[i].numpy() for x in s)   # noqa: E731
            scal = lambda s: tuple(x[i].numpy() for x in s)  # noqa: E731
            assert _merge_is_identity(row(path), scal(f2), row(dead),
                                      scal(dead2), k)


def _near_canonical_rows(k, seed, n=90):
    """A dead B under a canonical A with one flaw, or none: two live
    entries swapped, a key repeated, a zero of each sign, a payload below
    -1, a dead entry with a stray seq, a NaN fall-back, or B's fall-back
    live (which `_prefix_aggregates` never makes for a dead list)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        A, a2 = _random_side(rng, k, "canonical")
        B, b2 = _random_side(rng, k, "dead")
        P, T, S, Q, L = A
        m = int((P > HALF_NEG32).sum())
        flaw = i % 8
        if flaw == 1 and m >= 2:
            for x in A:
                x[[0, 1]] = x[[1, 0]]
        elif flaw == 2 and m >= 2:
            P[1], Q[1] = P[0], Q[0]
        elif flaw == 3 and m >= 2:
            P[m - 2], P[m - 1] = F32(0.0), F32(-0.0)
        elif flaw == 4 and m >= 1:
            T[0] = -5
        elif flaw == 5 and m < k:
            Q[m] = 7
        elif flaw == 6:
            a2 = (F32(np.nan),) + a2[1:]
        elif flaw == 7:
            b2 = (F32(8.0), np.int32(3), np.int32(9), np.int32(1),
                  np.int32(2))
            B[1][0] = T[0] if m else -1
        rows.append((A, a2, B, b2))
    return rows


@pytest.mark.parametrize("k", [1, 16, 32])
def test_identity_check_implies_merge2_identity(k):
    """Wherever the kernel's check skips a merge, the reference's
    `_merge2` returns the parent's path and fall-back unchanged (and the
    serial selection the same zero signs); each flaw of a near-canonical
    path under a dead list is caught."""
    rows = _rows(k, seed=500 + k, n=90) + _near_canonical_rows(k, 600 + k)
    (mP, mT, mS, mQ, mL), m2 = _ref_merge(rows, k)
    skipped = 0
    for i, (A, a2, B, b2) in enumerate(rows):
        if _merge_is_identity(A, a2, B, b2, k):
            skipped += 1
            _assert_row_equal((A, a2), (mP, mT, mS, mQ, mL), m2, i)
            serial = _serial_merge(A, a2, B, b2, k)[1]   # zero signs too
            assert np.array_equal(np.asarray(A[0], F32).view(np.int32),
                                  serial[0].view(np.int32))
        else:                 # merged: the mirror still equals _merge2
            _assert_row_equal(_rank_merge(A, a2, B, b2, k),
                              (mP, mT, mS, mQ, mL), m2, i)
    assert skipped


def _leaf_stage(path, f2, k, own, lim, floor):
    """The kernel's `leaf_stage` for one leaf, in numpy."""
    P, T, S, Q, L = path
    has_owner = own >= 0
    excl = has_owner & (T == own)
    all_owned = has_owner and P[0] > HALF_NEG32 and \
        not ((P > HALF_NEG32) & ~excl).any()
    E = np.append(np.where(excl, NEG32, P), f2[0] if all_owned else NEG32)
    ES, EL = np.append(S, f2[2]), np.append(L, f2[4])
    top = F32(np.nan) if np.isnan(E).any() else E.max()
    hit = np.flatnonzero((E >= top) & (E > HALF_NEG32))
    col0 = hit[0] if len(hit) else 0

    def nanmax(a, b):
        return F32(np.nan) if np.isnan(a) or np.isnan(b) else (
            a if a > b else b)
    r = nanmax(floor, nanmax(top, F32(0.0)))
    fl = F32(floor - F32(tref.EPSF))
    slate = np.where((E > HALF_NEG32) & (E >= fl), ES, -1)
    trunc = int(P[k - 1] > HALF_NEG32 and P[k - 1] >= fl)
    evict = int(has_owner and r > F32(lim + F32(tref.EPSF)))
    return r, (EL[col0] if top > HALF_NEG32 else -1), slate, trunc, evict


def _kernel_mirror(aggs, floors, level_off, strides, owner, limit, k,
                   per_block):
    """The whole kernel in numpy, block by block from its leaf plan:
    root lists, `node_path` level by level (a merge, or the parent's path
    where merging is the identity), then the leaf stage."""
    A = [x.numpy() for x in aggs]
    floors = [f.numpy() for f in floors]
    owner, limit = owner.numpy(), limit.numpy()
    n = owner.shape[0]
    n_lvl = len(strides)
    out = (np.zeros(n, F32), np.zeros(n, np.int32),
           np.zeros((n, k + 1), np.int32), np.zeros(n, np.int32),
           np.zeros(n, np.int32))
    plan = tkern.leaf_plan(strides, n, per_block)

    def own(d, node):
        g = level_off[d] + node
        lst = tuple(A[f][g].copy() for f in range(4))
        lst += (np.where(lst[0] > HALF_NEG32, d, -1).astype(np.int32),)
        f2 = tuple(A[4 + f][g] for f in range(4))
        return lst, f2 + (np.int32(d if f2[0] > HALF_NEG32 else -1),)

    for b in range(plan.shape[0]):
        lo, cnt, _ = plan[b]
        paths = {lo[-1] + i: own(n_lvl - 1, lo[-1] + i)
                 for i in range(cnt[-1])}
        for d in range(n_lvl - 2, -1, -1):
            new = {}
            for node in range(lo[d], lo[d] + cnt[d]):
                pa, pa2 = paths[node * strides[d] // strides[d + 1]]
                lst, f2 = own(d, node)
                new[node] = _node_path(pa, pa2, lst, f2, k)
            paths = new
        for leaf in range(b * per_block, min(n, (b + 1) * per_block)):
            floor = F32(0.0)
            for d in range(n_lvl):
                v = floors[d][leaf // strides[d]]
                floor = F32(np.nan) if np.isnan(floor) or np.isnan(v) \
                    else (floor if floor > v else v)
            path, f2 = paths[leaf // strides[0]]
            res = _leaf_stage(path, f2, k, owner[leaf], limit[leaf], floor)
            for o, v in zip(out, res):
                o[leaf] = v
    return out


@pytest.mark.parametrize("case", [
    "n768-k8", "n24-nonpow2-k4", "hazard-n768-k8", "hazard-n24-k4",
    "hazard-n24-k32", "hazard-n64deep-k8", "lap", "trunc"])
def test_kernel_mirror_matches_plain(case):
    """The kernel's whole algorithm (block plan, merges, skips, leaf
    stage), run in numpy at 32 and 7 leaves a block, equals the plain
    version on engine books and on lists with every hazard (NaN prices,
    equal keys, ±0.0, unsorted and stray lists)."""
    from test_torch_cuda import _hazard_aggs, _lap_book, _truncated_book
    if case.startswith("hazard"):
        _, shape, kk = case.split("-")
        tree = _tree({"n24": "n24-nonpow2", "n64deep": "n64-deep"}
                     .get(shape, shape))
        k = int(kk[1:])
        aggs = _hazard_aggs(tree, k, 70 + k, "cpu")
        rng = np.random.default_rng(k)
        level_off, acc, floors = [], 0, []
        for d in range(tree.n_levels):
            level_off.append(acc)
            acc += tree.nodes_at(d)
            floors.append(torch.from_numpy(rng.choice(
                F32([0, 0.5, 2]), tree.nodes_at(d))))
        n = tree.n_leaves
        owner = torch.from_numpy(rng.integers(-1, 6, n).astype(np.int32))
        limit = torch.from_numpy(rng.uniform(1, 6, n).astype(F32))
        args = (tuple(floors), tuple(level_off), tree.strides, owner, limit)
    else:
        if case == "lap":
            eng, st = _lap_book("cpu")
        elif case == "trunc":
            eng, st = _truncated_book("cpu")
        else:
            shape, kk = case.rsplit("-", 1)
            eng, st = _random_book(_tree(shape), int(kk[1:]), seed=3)
        k = eng.k
        n_seg = st["seg_start"].shape[0] - 1
        aggs = tref._prefix_aggregates(st["order"], st["sorted_gseg"],
                                       st["seg_start"], st["price"],
                                       st["tenant"], st["seq"], n_seg, k)
        args = (tuple(st["floor"]), eng.level_off, eng.tree.strides,
                st["owner"], st["limit"])
    plain = tref.clear_sorted_from_aggs(aggs, *args, k)
    for per_block in (32, 7):
        got = _kernel_mirror(aggs, *args, k, per_block)
        assert np.array_equal(got[0], plain[0].numpy(), equal_nan=True)
        for name, a, b in zip(NAMES[1:], got[1:], plain[1:]):
            assert np.array_equal(a, b.numpy()), (case, per_block, name)
