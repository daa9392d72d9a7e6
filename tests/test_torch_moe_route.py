"""Parity of the port's MoE router plain version
(``repro_torch.kernels.moe_route.ref.route_ref``) with the reference's
``route_ref`` (``lax.top_k``) and its Pallas kernel ``route_pallas`` in
interpret mode, on the CPU, both through the reference's jitted
``ops.route``; and of the dense combine weights
(``ref.route_dense_ref``) with the ones the reference's ``moe_dense``
builds (``_router_topk``, then ``.at[].set`` and ``astype``).

Indices must be equal; weights agree to rtol 1e-5 / atol 1e-6 (the
softmax's exponentials and sums are computed by another library in
another order).  The Pallas kernel is run once per (E, k, renormalize)
on the T cases stacked (rows are independent), so the interpreter runs
12 times, not 36; the reference's dense weights likewise, 18 times.

The dense weights: the reference's own scatter and cast of the port's
weights give the port's dense row bit for bit (float32 and bfloat16);
against the reference's dense row the zeros are the same (+0.0), the
float32 values within the weight tolerance above, and the bfloat16
values within one bfloat16 step (a weight one float32 ulp away may
round to the neighbouring bfloat16 value).
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_route.ops import route as jax_route
from repro.models.layers import _router_topk as jax_router_topk
from repro_torch.kernels.moe_route import ops
from repro_torch.kernels.moe_route.ref import route_dense_ref, route_ref

TS = (1, 7, 300)
ES = (8, 64)
KS = (1, 2, 8)
DENSE_TS = (1, 4, 37)
DENSE_ES = (8, 60, 64)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends.  Each holds
    memory mappings; a test worker that gathers more than the kernel's
    ``vm.max_map_count`` (65,530) crashes in a later XLA compile."""
    yield
    jax.clear_caches()
    gc.collect()


def _logits(T, E, seed=0):
    rng = np.random.default_rng(1000 * E + T + seed)
    return rng.standard_normal((T, E)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pallas(E, k, renorm):
    """route_pallas on every T case stacked, split back per T."""
    x = np.concatenate([_logits(T, E) for T in TS])
    w, idx = jax_route(jnp.asarray(x), k=k, renormalize=renorm,
                       use_pallas=True, interpret=True)
    w, idx = np.asarray(w), np.asarray(idx)
    out, at = {}, 0
    for T in TS:
        out[T] = (w[at:at + T], idx[at:at + T])
        at += T
    return out


def _check(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("E", ES)
@pytest.mark.parametrize("T", TS)
def test_route_plain_matches_reference(T, E, k, renorm):
    x = _logits(T, E)
    got = route_ref(torch.from_numpy(x), k, renorm)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert got[0].shape == got[1].shape == (T, k)
    _check(got, jax_route(jnp.asarray(x), k=k, renormalize=renorm,
                          use_pallas=False))
    _check(got, _pallas(E, k, renorm)[T])


@pytest.mark.parametrize("renorm", [False, True])
def test_route_ties_lowest_index_first(renorm):
    """Equal logits: the lowest expert index comes first, as lax.top_k
    and the Pallas kernel put it (torch.topk makes no such promise)."""
    x = np.zeros((6, 64), np.float32)
    x[1, ::2] = 1.0                     # 32 tied maxima
    x[2] = np.repeat(np.arange(32, dtype=np.float32), 2)[::-1]
    x[3, 5] = x[3, 9] = x[3, 60] = 3.0
    x[4] = np.tile(np.arange(8, dtype=np.float32), 8)
    x[5] = np.random.default_rng(3).standard_normal(64).round(0)
    got = route_ref(torch.from_numpy(x), 8, renorm)
    _check(got, jax_route(jnp.asarray(x), k=8, renormalize=renorm,
                          use_pallas=False))
    _check(got, jax_route(jnp.asarray(x), k=8, renormalize=renorm,
                          use_pallas=True, interpret=True))
    assert got[1][0].tolist() == list(range(8))
    assert got[1][1].tolist() == list(range(0, 16, 2))
    assert got[1][3, :3].tolist() == [5, 9, 60]


def test_route_ops_dispatch_by_device():
    """A CPU tensor takes the plain version (``route_dense``: top-k and
    dense weights), and so does a ``meta`` one (shapes and dtypes only:
    the dry run traces there); k outside [1, E] raises; a device with no
    router raises rather than falling back."""
    from test_torch_dryrun import OtherDevice
    x = torch.from_numpy(_logits(7, 60))
    got = ops.route_dense(x, 8, True, torch.bfloat16)
    want = route_dense_ref(x, 8, True, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[2].dtype == torch.bfloat16 and got[2].shape == (7, 60)
    meta = ops.route_dense(x.to("meta"), 8, True, torch.bfloat16)
    assert [(t.shape, t.dtype, t.is_meta) for t in meta] == \
        [(t.shape, t.dtype, True) for t in want]
    with pytest.raises(ValueError):
        route_ref(x, 61)
    with pytest.raises(ValueError, match="device"):
        ops.route_dense(OtherDevice(x), 8, True, torch.bfloat16)


# ---------------------------------------------------- dense combine weights
@functools.partial(jax.jit, static_argnames=("k", "renorm"))
def _jax_dense(x, w_port, idx_port, *, k, renorm):
    """The reference's dense combine weights as its ``moe_dense`` builds
    them from ``x``, and its scatter and cast of the port's (w, idx)."""
    T, E = x.shape
    rows = jnp.arange(T, dtype=jnp.int32)[:, None]
    w, idx = jax_router_topk(x, k, renorm)
    dense = jnp.zeros((T, E), jnp.float32).at[rows, idx].set(w)
    port = jnp.zeros((T, E), jnp.float32).at[rows, idx_port].set(w_port)
    return (idx, {"float32": dense, "bfloat16": dense.astype(jnp.bfloat16)},
            {"float32": port, "bfloat16": port.astype(jnp.bfloat16)})


def _split_rows(x, sizes):
    out, at = [], 0
    for n in sizes:
        out.append(x[at:at + n])
        at += n
    return out


@functools.lru_cache(maxsize=None)
def _reference_dense(E, k, renorm):
    """``_jax_dense`` on every DENSE_TS case stacked, split back per T;
    the port's (w, idx) it scatters come from ``route_ref`` on each
    case's own logits."""
    xs = [_logits(T, E, seed=1) for T in DENSE_TS]
    port = [route_ref(torch.from_numpy(x), k, renorm) for x in xs]
    idx, ref, scat = _jax_dense(
        jnp.asarray(np.concatenate(xs)),
        jnp.asarray(np.concatenate([w.numpy() for w, _ in port])),
        jnp.asarray(np.concatenate([i.numpy() for _, i in port])),
        k=k, renorm=renorm)
    parts = {"idx": _split_rows(np.asarray(idx), DENSE_TS)}
    for name, d in (("ref", ref), ("scatter", scat)):
        for dt, a in d.items():
            parts[name, dt] = _split_rows(np.asarray(a), DENSE_TS)
    return {T: {key: v[i] for key, v in parts.items()}
            for i, T in enumerate(DENSE_TS)}


def _bits(a):
    """Raw bits of a float32 or bfloat16 array (numpy or torch)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16
                   else torch.int32).numpy()
        return a.view(np.uint16 if a.dtype == np.int16 else np.uint32)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _check_dense(got, idx_ref, ref, scattered, dtype):
    w, idx, dense = got
    assert dense.dtype == getattr(torch, dtype) and dense.shape == ref.shape
    np.testing.assert_array_equal(idx.numpy(), idx_ref)
    # the reference's scatter and cast of these weights: bit for bit
    np.testing.assert_array_equal(_bits(dense), _bits(scattered))
    # against the reference's own dense row: the same +0.0 zeros ...
    d, r = dense.float().numpy(), np.asarray(ref, np.float32)
    assert np.array_equal(d == 0, r == 0) and not np.signbit(d).any()
    if dtype == "float32":        # ... and the weight tolerance
        np.testing.assert_allclose(d, r, rtol=1e-5, atol=1e-6)
    else:                         # ... or one bfloat16 step (all >= +0)
        step = np.abs(_bits(dense).astype(np.int32)
                      - _bits(ref).astype(np.int32))
        assert step.max() <= 1, step.max()


@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("E", DENSE_ES)
@pytest.mark.parametrize("T", DENSE_TS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_dense_ref_matches_reference(dtype, T, E, k, renorm):
    x = _logits(T, E, seed=1)
    got = route_dense_ref(torch.from_numpy(x), k, renorm,
                          getattr(torch, dtype))
    want = _reference_dense(E, k, renorm)[T]
    w0, idx0 = route_ref(torch.from_numpy(x), k, renorm)
    assert torch.equal(got[0], w0) and torch.equal(got[1], idx0)
    _check_dense(got, want["idx"], want["ref", dtype],
                 want["scatter", dtype], dtype)


@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_dense_ref_ties(dtype, renorm):
    """Tied logits, with the tie straddling the k-th place: the dense
    row keeps the lowest tied indices, as the reference's does."""
    x = np.zeros((5, 60), np.float32)
    x[1, ::2] = 1.0                     # 30 tied maxima, 8 kept
    x[2] = np.repeat(np.arange(30, dtype=np.float32), 2)[::-1]
    x[3, 5] = x[3, 9] = x[3, 59] = 3.0
    x[4] = np.random.default_rng(4).standard_normal(60).round(0)
    got = route_dense_ref(torch.from_numpy(x), 8, renorm,
                          getattr(torch, dtype))
    idx, ref, scat = _jax_dense(jnp.asarray(x), jnp.asarray(got[0].numpy()),
                                jnp.asarray(got[1].numpy()), k=8,
                                renorm=renorm)
    _check_dense(got, np.asarray(idx), np.asarray(ref[dtype]),
                 np.asarray(scat[dtype]), dtype)
    assert (got[2][0] != 0).nonzero().flatten().tolist() == list(range(8))
    assert (got[2][1] != 0).nonzero().flatten().tolist() == \
        list(range(0, 16, 2))


# ------------------------------------------- the CUDA kernel's rounds (numpy)
def _key_rounds_mirror(p, k):
    """numpy mirror of ``route_kernel``'s k rounds (``csrc/moe_route.cu``):
    expert e in lane e % 32, slot e // 32; key = bits(p) + 1 (0 = taken or
    absent); a lane's best is its first slot holding its largest key, the
    round's value the warp max of those keys (``__reduce_max_sync``), its
    winner the least index among lanes at that max
    (``__reduce_min_sync``)."""
    T, E = p.shape
    S = 1
    while 32 * S < E:
        S *= 2
    key = np.zeros((T, 32 * S), np.uint32)
    key[:, :E] = p.astype(np.float32).view(np.uint32) + 1
    key = key.reshape(T, S, 32)                      # [t, slot, lane]
    w = np.zeros((T, k), np.float32)
    idx = np.zeros((T, k), np.int32)
    for r in range(k):
        bj = key.argmax(axis=1)                      # first slot at the max
        best = np.take_along_axis(key, bj[:, None, :], 1)[:, 0]
        top = best.max(axis=1)
        cand = np.where(best == top[:, None], np.arange(32) + 32 * bj, 512)
        bi = cand.min(axis=1)
        w[:, r] = (top - 1).astype(np.uint32).view(np.float32)
        idx[:, r] = bi
        key[np.arange(T), bi // 32, bi % 32] = 0
    return w, idx


@pytest.mark.parametrize("E,k", [(8, 8), (60, 8), (64, 8), (64, 64),
                                 (100, 8), (512, 64)])
def test_kernel_key_rounds_mirror_matches_plain(E, k):
    """The kernel's integer-key rounds pick what ``route_ref``'s float
    rounds pick, bit for bit, on the same probabilities: random rows,
    pairs of tied experts, all-equal rows, and rows whose probabilities
    underflow to +0 except one (the zero experts then go in index
    order, after the one)."""
    rng = np.random.default_rng(E + k)
    x = rng.standard_normal((40, E)).astype(np.float32)
    x[::3] = np.repeat(x[::3, : (E + 1) // 2], 2, axis=1)[:, :E]
    x[1::5] = 0.5
    x[2::7, E // 2] = 150.0
    p = torch.softmax(torch.from_numpy(x), dim=-1)
    assert (p[2] == 0).sum() == E - 1
    w, idx = _key_rounds_mirror(p.numpy(), k)
    w0, idx0 = route_ref(torch.from_numpy(x), k, False)
    np.testing.assert_array_equal(idx, idx0.numpy())
    np.testing.assert_array_equal(w.view(np.uint32), w0.numpy()
                                  .view(np.uint32))
