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
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.models.layers import ssd_chunked
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan import ref as R
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
    _jax_backward.cache_clear()
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
def _rnd(t, dtype):
    """An MMA operand formed in float32, rounded to the inputs' dtype."""
    return t.to(dtype).float()


def _carried_states(x, dt, A, Bm, chunk):
    """Passes 1 and 2 of ``csrc/ssd_scan.cu``: each chunk's own state
    (x dt exp(cum_last - cum))ᵀ B, that operand split into a bfloat16
    head and remainder for bfloat16 inputs, then the states carried over
    the chunks in order.  Returns the chunks' (dt, cum), the state
    entering each chunk, each chunk's cum_last and the final state."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    nc = -(-s // chunk)
    xf, Bf = x.float(), Bm.float()
    local = torch.zeros((b, nc, h, p, n))
    cdecay = torch.zeros((b, nc, h))
    cums = []
    for c in range(nc):                                   # pass 1
        s0, nv = c * chunk, min(chunk, s - c * chunk)
        d = dt[:, s0:s0 + nv]
        cum = torch.cumsum(d * A, dim=1)                  # (b, nv, h)
        cums.append((d, cum))
        v = xf[:, s0:s0 + nv] * (d * torch.exp(cum[:, -1:] - cum))[..., None]
        hi = _rnd(v, x.dtype)
        for part in (hi, _rnd(v - hi, x.dtype)) \
                if x.dtype == torch.bfloat16 else (v,):
            local[:, c] += torch.einsum("bjhp,bjn->bhpn", part,
                                        Bf[:, s0:s0 + nv])
        cdecay[:, c] = cum[:, -1]
    entering, state = [], torch.zeros((b, h, p, n))
    for c in range(nc):                                   # pass 2
        entering.append(state)
        state = torch.exp(cdecay[:, c])[..., None, None] * state + local[:, c]
    return cums, entering, cdecay, state


def _decay(cum):
    """exp(cum_i - cum_j) for j <= i, else 0 (masked before the exp):
    (b, i, j, h)."""
    nv = cum.shape[1]
    mask = torch.ones((nv, nv), dtype=torch.bool).tril()[None, :, :, None]
    gap = cum[:, :, None, :] - cum[:, None, :, :]
    return torch.exp(torch.where(mask, gap, float("-inf")))


def _three_pass_mirror(x, dt, A, Bm, Cm, chunk):
    """Plain-PyTorch mirror of ``csrc/ssd_scan.cu``'s decomposition, with
    its roundings for bfloat16 inputs: passes 1-2 (``_carried_states``),
    then (3) each chunk's y = (C Bᵀ ∘ L ∘ dt) x, L formed only for j <= i
    and W rounded to the inputs' dtype, plus exp(cum) C S_cᵀ with S_c
    rounded likewise (chunk 0 enters with zero state)."""
    b, s, h, p = x.shape
    cums, entering, _, state = _carried_states(x, dt, A, Bm, chunk)
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    y = torch.zeros((b, s, h, p))
    for c, (d, cum) in enumerate(cums):                   # pass 3
        s0, nv = c * chunk, d.shape[1]
        G = torch.einsum("bin,bjn->bij", Cf[:, s0:s0 + nv], Bf[:, s0:s0 + nv])
        W = _rnd(G[..., None] * _decay(cum) * d[:, None, :, :], x.dtype)
        yc = torch.einsum("bijh,bjhp->bihp", W, xf[:, s0:s0 + nv])
        if c:
            yc = yc + torch.exp(cum)[..., None] * torch.einsum(
                "bin,bhpn->bihp", Cf[:, s0:s0 + nv],
                _rnd(entering[c], x.dtype))
        y[:, s0:s0 + nv] = yc
    return y.to(x.dtype), state


def _backward_mirror(x, dt, A, Bm, Cm, chunk, g_y, g_state):
    """Plain-PyTorch mirror of the CUDA backward's passes, with its
    roundings for bfloat16 inputs -> (gx, gdt, gA, gBm, gCm).  Passes
    1-2 again; (1') D_c = (g_y exp(cum))ᵀ C, split like pass 1; (2') the
    state gradients R_c walked from the last chunk (R = g_state, or 0)
    with the carry's exp(L_c) <R_c, S_c>; (3') per chunk, with W and dG
    = dW ∘ L ∘ dt (dW = g_y xᵀ) rounded to the inputs' dtype as product
    operands, and R_c, S_c likewise: gx = Wᵀ g_y + u (B R_cᵀ), gB = Σ_h
    dGᵀ C + u (x R_c), gC = Σ_h dG B + exp(cum) (g_y S_c), the row and
    column sums of dW ∘ G ∘ L ∘ dt; (4') the gradient of cum, its
    reverse cumsum within the chunk, gdt and gA."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    dtype = x.dtype
    cums, entering, cdecay, _ = _carried_states(x, dt, A, Bm, chunk)
    nc = len(cums)
    xf, Bf, Cf, gyf = x.float(), Bm.float(), Cm.float(), g_y.float()
    R = g_state.float() if g_state is not None else torch.zeros(
        (b, h, p, n))
    leaving, carry = [None] * nc, [None] * nc
    for c in reversed(range(nc)):                         # 1', 2'
        leaving[c] = R
        decay = torch.exp(cdecay[:, c])                   # (b, h)
        carry[c] = decay * (R * entering[c]).sum((-1, -2))
        D = torch.zeros((b, h, p, n))
        if c:
            s0, (d, cum) = c * chunk, cums[c]
            v = gyf[:, s0:s0 + d.shape[1]] * torch.exp(cum)[..., None]
            hi = _rnd(v, dtype)
            for part in (hi, _rnd(v - hi, dtype)) \
                    if dtype == torch.bfloat16 else (v,):
                D += torch.einsum("bihp,bin->bhpn", part,
                                  Cf[:, s0:s0 + d.shape[1]])
        R = decay[..., None, None] * R + D
    gx = torch.zeros((b, s, h, p))
    gB = torch.zeros((b, s, n))
    gC = torch.zeros((b, s, n))
    gdt = torch.zeros((b, s, h))
    gA = torch.zeros((h,))
    for c, (d, cum) in enumerate(cums):                   # 3', 4'
        s0, nv = c * chunk, d.shape[1]
        sl = slice(s0, s0 + nv)
        E = _decay(cum)                                   # (b, i, j, h)
        G = torch.einsum("bin,bjn->bij", Cf[:, sl], Bf[:, sl])[..., None]
        dW = torch.einsum("bihp,bjhp->bijh", gyf[:, sl], xf[:, sl])
        dtj = d[:, None, :, :]
        W = _rnd(G * E * dtj, dtype)
        dG = _rnd(dW * E * dtj, dtype)
        M = dW * G * E                                    # without dt_j
        Rn = _rnd(leaving[c], dtype)
        ej = torch.exp(cum[:, -1:] - cum)                 # (b, j, h)
        u = ej * d
        gx[:, sl] = torch.einsum("bijh,bihp->bjhp", W, gyf[:, sl]) + \
            u[..., None] * torch.einsum("bjn,bhpn->bjhp", Bf[:, sl], Rn)
        V = torch.einsum("bjhp,bhpn->bjhn", xf[:, sl], Rn)
        du = torch.einsum("bjn,bjhn->bjh", Bf[:, sl], V)
        gB[:, sl] = torch.einsum("bijh,bin->bjn", dG, Cf[:, sl]) + \
            torch.einsum("bjh,bjhn->bjn", u, V)
        rowp = (M * dtj).sum(2)                           # (b, i, h)
        gC[:, sl] = torch.einsum("bijh,bjn->bin", dG, Bf[:, sl])
        if c:
            Z = torch.einsum("bihp,bhpn->bihn", gyf[:, sl],
                             _rnd(entering[c], dtype))
            Z = torch.exp(cum)[..., None] * Z
            gC[:, sl] += Z.sum(2)
            rowp = rowp + torch.einsum("bin,bihn->bih", Cf[:, sl], Z)
        colsum = M.sum(1)                                 # (b, j, h)
        tl = du * u
        gcum = rowp - d * colsum - tl
        gcum[:, -1] += tl.sum(1) + carry[c]
        rcs = gcum.flip(1).cumsum(1).flip(1)
        gdt[:, sl] = colsum + du * ej + A * rcs
        gA += (d * rcs).sum((0, 1))
    return gx.to(dtype), gdt, gA, gB.to(dtype), gC.to(dtype)


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


# ------------------------------------------------- the backward's algebra
# bfloat16 inputs against the reference's float32 gradient on the same
# rounded values, as a share of each gradient's largest magnitude: two
# bfloat16 roundings on each term's path (an operand formed in float32
# -- W, dG, the carried states -- and the rounded output, 2**-9 each),
# up to 5x by cancellation in the sums; the worst case, gA's sum over
# every position, read 7.9e-3 on these shapes.  (The card's kernel is
# held to the plain version by ``kernel.BWD_BF16_TOL``, a different pair.)
BWD_BF16_TOL = 2e-2


@functools.lru_cache(maxsize=None)
def _jax_backward(B, S, H, P, N, chunk):
    """One jitted vjp of the reference's ``ssd_chunked`` (float32) per
    shape: (inputs, cotangent of y, cotangent of the final state) ->
    the five input gradients."""
    def vjp(args, up_y, up_s):
        _, pull = jax.vjp(lambda *a: ssd_chunked(*a, chunk), *args)
        return pull((up_y, up_s))
    return jax.jit(vjp)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", MIRROR_CASES)
def test_backward_mirror_matches_reference(B, S, H, P, N, chunk, dtype,
                                           with_state):
    """The CUDA backward's passes, with its roundings, against the
    reference's gradient (the jitted vjp of ``ssd_chunked`` in float32)
    under an upstream gradient on y and, with ``with_state``, on the
    final state (training gives it none).  float32 within 1e-4, as
    ``test_torch_train.py::test_ssd_grad_matches_reference``; bfloat16
    inputs (x, Bm, Cm and the gradient of y rounded) against the float32
    gradient of the rounded values within ``BWD_BF16_TOL`` of each
    gradient's largest magnitude."""
    arrays = list(_inputs(B, S, H, P, N, S * 13 + chunk))
    rng = np.random.default_rng(S + chunk)
    up_y = rng.standard_normal((B, S, H, P)).astype(np.float32)
    up_s = rng.standard_normal((B, H, P, N)).astype(np.float32)
    if dtype == "bfloat16":                  # the values the kernel reads
        for i in (0, 3, 4):
            arrays[i] = torch.from_numpy(arrays[i]).bfloat16().float().numpy()
        up_y = torch.from_numpy(up_y).bfloat16().float().numpy()
    want = _jax_backward(B, S, H, P, N, chunk)(
        tuple(jnp.asarray(a) for a in arrays), jnp.asarray(up_y),
        jnp.asarray(up_s if with_state else np.zeros_like(up_s)))
    _, t = _both(arrays, dtype)
    got = _backward_mirror(*t, chunk,
                           torch.from_numpy(up_y).to(t[0].dtype),
                           torch.from_numpy(up_s) if with_state else None)
    for name, g, w, inp in zip(("x", "dt", "A", "Bm", "Cm"), got, want, t):
        assert g.dtype == inp.dtype and g.shape == inp.shape, name
        w = np.asarray(w)
        if dtype == "float32":
            _close(g, w, 1e-4, name)
        else:
            scale = float(np.abs(w).max())
            err = float(np.abs(g.float().numpy() - w).max())
            assert 0 < scale and err <= BWD_BF16_TOL * scale, \
                (name, err, scale)


def test_backward_keeps_the_plain_route_off_the_card(monkeypatch):
    """On ``cpu`` tensors ``ssd_scan_backward`` is the plain version
    under autograd, bit for bit, and so is the Function's backward; on
    ``meta`` ones it gives the plain version's shapes and dtypes (the dry
    run's mamba2 cells trace there); neither launches the backward
    kernel, and any other device is an error."""
    from test_torch_dryrun import OtherDevice
    calls = []
    plain = R.ssd_scan_backward_ref
    monkeypatch.setattr(R, "ssd_scan_backward_ref",
                        lambda *a: calls.append(a[0][0].device.type)
                        or plain(*a))
    B, S, H, P, N, chunk = 1, 24, 2, 16, 16, 16
    args = tuple(torch.from_numpy(a) for a in _inputs(B, S, H, P, N, 6))
    rng = np.random.default_rng(7)
    g_y = torch.from_numpy(rng.standard_normal((B, S, H, P))
                           .astype(np.float32))
    needs = (True, True, False, True, True)
    before = K.BACKWARD_LAUNCHES
    got = ops.ssd_scan_backward(args, chunk, g_y, None, needs)
    want = plain(args, chunk, g_y, None, needs)
    assert got[2] is None and want[2] is None
    assert all(torch.equal(a, b) for a, b in zip(got, want) if a is not None)
    ins = [a.clone().requires_grad_(True) for a in args]
    y, _ = ops.ssd_scan(*ins, chunk)
    (y * g_y).sum().backward()
    for t, w in zip(ins, plain(args, chunk, g_y, None, (True,) * 5)):
        assert torch.equal(t.grad, w)
    meta = ops.ssd_scan_backward(tuple(a.to("meta") for a in args), chunk,
                                 g_y.to("meta"), None, needs)
    for m, w in zip(meta, want):
        assert (m is None) == (w is None)
        if m is not None:
            assert m.is_meta and (m.shape, m.dtype) == (w.shape, w.dtype)
    assert calls == ["cpu", "cpu", "meta"]
    assert K.BACKWARD_LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        ops.ssd_scan_backward(tuple(map(OtherDevice, args)), chunk, g_y,
                              None, needs)

