"""Parity of the port's MoE router plain version
(``repro_torch.kernels.moe_route.ref.route_ref``) with the reference's
``route_ref`` (``lax.top_k``) and its Pallas kernel ``route_pallas`` in
interpret mode, on the CPU, both through the reference's jitted
``ops.route``.

Indices must be equal; weights agree to rtol 1e-5 / atol 1e-6 (the
softmax's exponentials and sums are computed by another library in
another order).  The Pallas kernel is run once per (E, k, renormalize)
on the T cases stacked (rows are independent), so the interpreter runs
12 times, not 36.
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_route.ops import route as jax_route
from repro_torch.kernels.moe_route import ops
from repro_torch.kernels.moe_route.ref import route_ref

TS = (1, 7, 300)
ES = (8, 64)
KS = (1, 2, 8)


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
    """A CPU tensor takes the plain version; k outside [1, E] raises;
    a device with no route raises rather than falling back."""
    x = torch.from_numpy(_logits(7, 8))
    w, idx = ops.route(x, 2, False)
    w0, idx0 = route_ref(x, 2, False)
    assert torch.equal(w, w0) and torch.equal(idx, idx0)
    with pytest.raises(ValueError):
        route_ref(x, 9)
    with pytest.raises(ValueError, match="device"):
        ops.route(x.to("meta"), 2)
