"""Parity of the port's clearing pass (``repro_torch.kernels.market_clear``)
with the JAX reference ``repro.kernels.market_clear.ops.clear``.

The same sorted books, built from numpy-seeded inputs, go through the
reference's jnp path and the port's CPU path; all five outputs must be
equal element for element (the pass is comparisons and max only, so no
tolerance).  One case also holds the port against the reference's
Pallas kernel in interpret mode.  The CUDA kernel is held to the plain
version in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
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


def _tree(shape):
    if shape == "n24-nonpow2":
        return TreeSpec(24, (1, 4, 12, 24))     # non-power-of-two strides
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
