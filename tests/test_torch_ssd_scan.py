"""Parity of the port's SSD scan plain version
(``repro_torch.kernels.ssd_scan.ref.ssd_scan_ref``) with the reference's
``ssd_scan`` on the CPU: its jnp oracle (``use_pallas=False``, the
model's ``ssd_chunked``) and its Pallas kernel in interpret mode
(``use_pallas=True``, only where ``S % chunk == 0``, which the Pallas
kernel asserts), both through the reference's jitted ``ops.ssd_scan``.

Tolerances are the reference's own kernel tests' (tests/test_kernels.py):
3e-4 in float32 (the reference carries the state with an associative
scan, the port walks the chunks in order, so the float32 sums run in
another order) and 4e-2 in bfloat16 (y is rounded to bfloat16 after
those sums).  The final state is float32 in both dtypes and is held at
3e-4 in both.  It is also held to a float64 per-token
recurrence at 1e-4, as the reference's
``test_ssd_state_matches_sequential_decode``.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

torch.set_num_threads(1)     # small tensors; leave the cores to XLA

# (B, S, H, P, N, chunk): whole chunks, a partial last chunk, a single
# partial chunk, odd widths, and a chunk as long as the sequence
CASES = [
    (2, 64, 4, 16, 32, 16),
    (1, 40, 4, 16, 32, 16),
    (2, 13, 2, 16, 16, 16),
    (1, 37, 3, 8, 24, 8),
    (1, 48, 2, 16, 16, 48),
]


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends.  Each holds
    memory mappings; a test worker that gathers more than the kernel's
    ``vm.max_map_count`` (65,530) crashes in a later XLA compile."""
    yield
    jax.clear_caches()
    gc.collect()


def _inputs(B, S, H, P, N, seed, dt_lo=0.001, dt_hi=0.1, a_lo=0.5,
            a_hi=4.0):
    """The reference kernel test's distributions."""
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((B, S, H, P)) * 0.3).astype(np.float32),
        rng.uniform(dt_lo, dt_hi, (B, S, H)).astype(np.float32),
        -rng.uniform(a_lo, a_hi, (H,)).astype(np.float32),
        (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32),
        (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32))


def _both(arrays, dtype):
    """(jax arrays, torch tensors) of the same numpy inputs; x, Bm and Cm
    in ``dtype``, dt and A float32."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x, dt, A, Bm, Cm = arrays
    j = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt))
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
         torch.from_numpy(Cm).to(tdt))
    return j, t


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES)
def test_ssd_plain_matches_reference(B, S, H, P, N, chunk, dtype):
    j, t = _both(_inputs(B, S, H, P, N, S * 7 + chunk), dtype)
    y, st = ssd_scan_ref(*t, chunk)
    assert y.dtype == t[0].dtype and st.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(st.shape) == (B, H, P, N)
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    jy, jst = jax_ssd_scan(*j, chunk=chunk, use_pallas=False)
    _close(y, jy, tol, "y vs ref")
    _close(st, jst, 3e-4, "state vs ref")
    if S % chunk == 0:
        py, pst = jax_ssd_scan(*j, chunk=chunk, use_pallas=True,
                               interpret=True, block_h=H)
        _close(y, py, tol, "y vs Pallas")
        _close(st, pst, 3e-4, "state vs Pallas")


@pytest.mark.parametrize("S,chunk", [(64, 16), (40, 16)])
def test_ssd_state_matches_sequential_recurrence(S, chunk):
    """Final state == the per-token recurrence in float64 (the
    reference's test, and with a partial last chunk)."""
    B, H, P, N = 1, 2, 16, 32
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, N, S, dt_lo=0.01, a_hi=2.0)
    _, st = ssd_scan_ref(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                         chunk)
    h = np.zeros((B, H, P, N), np.float64)
    for s in range(S):
        dA = np.exp(dt[:, s] * A)
        h = dA[..., None, None] * h + np.einsum(
            "bhp,bn->bhpn", dt[:, s, :, None] * x[:, s], Bm[:, s])
    np.testing.assert_allclose(st.numpy(), h, rtol=1e-4, atol=1e-4)


def test_ssd_plain_reads_strided_slices():
    """x, Bm and Cm as slices of one (B, S, H*P + 2N) tensor, as
    ``ssd_block`` hands them over: the same result as contiguous
    copies."""
    B, S, H, P, N, chunk = 2, 40, 4, 16, 32, 16
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in
                        _inputs(B, S, H, P, N, 3))
    xbc = torch.cat([x.reshape(B, S, H * P), Bm, Cm], dim=-1)
    xs, bs, cs = torch.split(xbc, [H * P, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    assert not xs.is_contiguous() and not bs.is_contiguous()
    y0, s0 = ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    y1, s1 = ops.ssd_scan(xs, dt, A, bs, cs, chunk)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)


def test_ops_dispatch():
    """A CPU tensor takes the plain version, bit for bit, and so does a
    ``meta`` one (shapes and dtypes only: the dry run traces there); any
    other device is an error."""
    from test_torch_dryrun import OtherDevice
    args = tuple(torch.from_numpy(a) for a in _inputs(1, 24, 2, 16, 16, 5))
    y0, s0 = ssd_scan_ref(*args, 16)
    y1, s1 = ops.ssd_scan(*args, chunk=16)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    ym, sm = ops.ssd_scan(*(a.to("meta") for a in args), chunk=16)
    assert (ym.shape, ym.dtype, sm.shape, sm.dtype) == \
        (y0.shape, y0.dtype, s0.shape, s0.dtype) and ym.is_meta
    with pytest.raises(ValueError, match="device"):
        ops.ssd_scan(*map(OtherDevice, args), chunk=16)



# ---------------------------------------------- the CUDA kernel's algebra
def _three_pass_mirror(x, dt, A, Bm, Cm, chunk):
    """Plain-PyTorch mirror of ``csrc/ssd_scan.cu``'s decomposition, with
    its roundings for bfloat16 inputs: (1) each chunk's own state
    (x dt exp(cum_last - cum))ᵀ B, that operand split into a bfloat16
    head and remainder; (2) the states carried over the chunks in order;
    (3) each chunk's y = (C Bᵀ ∘ L ∘ dt) x, L formed only for j <= i and
    W rounded to the inputs' dtype, plus exp(cum) C S_cᵀ with S_c rounded
    likewise (chunk 0 enters with zero state)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    nc = -(-s // chunk)

    def rnd(t):                       # an MMA operand formed in float32
        return t.to(x.dtype).float()
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    local = torch.zeros((b, nc, h, p, n))
    cdecay = torch.zeros((b, nc, h))
    cums = []
    for c in range(nc):                                   # pass 1
        s0, nv = c * chunk, min(chunk, s - c * chunk)
        d = dt[:, s0:s0 + nv]
        cum = torch.cumsum(d * A, dim=1)                  # (b, nv, h)
        cums.append((d, cum))
        v = xf[:, s0:s0 + nv] * (d * torch.exp(cum[:, -1:] - cum))[..., None]
        hi = rnd(v)
        for part in (hi, rnd(v - hi)) if x.dtype == torch.bfloat16 else (v,):
            local[:, c] += torch.einsum("bjhp,bjn->bhpn", part,
                                        Bf[:, s0:s0 + nv])
        cdecay[:, c] = cum[:, -1]
    entering, state = [], torch.zeros((b, h, p, n))
    for c in range(nc):                                   # pass 2
        entering.append(state)
        state = torch.exp(cdecay[:, c])[..., None, None] * state + local[:, c]
    y = torch.zeros((b, s, h, p))
    for c in range(nc):                                   # pass 3
        s0 = c * chunk
        d, cum = cums[c]
        nv = d.shape[1]
        G = torch.einsum("bin,bjn->bij", Cf[:, s0:s0 + nv], Bf[:, s0:s0 + nv])
        mask = torch.ones((nv, nv), dtype=torch.bool).tril()[None, :, :, None]
        gap = cum[:, :, None, :] - cum[:, None, :, :]     # (b, i, j, h)
        L = torch.exp(torch.where(mask, gap, float("-inf")))
        W = rnd(G[..., None] * L * d[:, None, :, :])
        yc = torch.einsum("bijh,bjhp->bihp", W, xf[:, s0:s0 + nv])
        if c:
            yc = yc + torch.exp(cum)[..., None] * torch.einsum(
                "bin,bhpn->bihp", Cf[:, s0:s0 + nv], rnd(entering[c]))
        y[:, s0:s0 + nv] = yc
    return y.to(x.dtype), state


# (B, S, H, P, N, chunk): several chunks, a partial last chunk, S < Q,
# S = Q (one chunk), the reduced widths (Q, N, P 16), odd widths
MIRROR_CASES = [
    (2, 64, 4, 16, 32, 16),
    (1, 40, 4, 16, 32, 16),
    (2, 13, 2, 16, 16, 16),
    (1, 48, 2, 16, 16, 48),
    (1, 37, 3, 24, 40, 8),
    (1, 100, 2, 16, 16, 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", MIRROR_CASES)
def test_three_pass_mirror_matches_reference(B, S, H, P, N, chunk, dtype):
    """The decomposition the CUDA kernel runs, with its bfloat16
    roundings, against the reference's jnp oracle at the reference's
    kernel tolerances (y 3e-4 / 4e-2, the float32 state 3e-4)."""
    j, t = _both(_inputs(B, S, H, P, N, S * 11 + chunk), dtype)
    y, st = _three_pass_mirror(*t, chunk)
    assert y.dtype == t[0].dtype and tuple(st.shape) == (B, H, P, N)
    tol = 4e-2 if dtype == "bfloat16" else 3e-4
    jy, jst = jax_ssd_scan(*j, chunk=chunk, use_pallas=False)
    _close(y, jy, tol, "y vs ref")
    _close(st, jst, 3e-4, "state vs ref")
