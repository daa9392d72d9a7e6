"""Parity of the port's flash-decode plain version
(``repro_torch.kernels.decode_attention.ref.decode_attention_ref``) with
the reference's ``decode_attention_ref`` and its Pallas kernel
``decode_attention_pallas`` in interpret mode, on the CPU, both through
the reference's jitted ``ops.decode_attention`` (one compile a case).

Tolerances are the reference's own kernel tests' (tests/test_kernels.py):
2e-5 in float32 (the same float32 sums taken in another order) and 3e-2
in bfloat16 (the output is rounded to bfloat16 after float32 sums that
differ in the last bits).
"""
import gc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import \
    decode_attention as jax_decode
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# (B, S, K, G, hd, window, pos, block_s): pos at 0, mid and S-1, windowed
# and not, MHA/GQA/MQA, and S that is not a multiple of 128
CASES = [
    (2, 256, 2, 2, 64, 0, 0, 128),
    (2, 256, 2, 2, 64, 0, 130, 128),
    (2, 256, 2, 2, 64, 0, 255, 128),
    (1, 256, 1, 4, 128, 64, 200, 128),
    (1, 256, 2, 1, 128, 32, 20, 128),
    (1, 200, 2, 1, 64, 48, 150, 200),      # ragged S: one Pallas block
    (2, 37, 2, 2, 16, 0, 36, 37),
]


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends.  Each holds
    memory mappings; a test worker that gathers more than the kernel's
    ``vm.max_map_count`` (65,530) crashes in a later XLA compile."""
    yield
    jax.clear_caches()
    gc.collect()


def _inputs(B, S, K, G, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, K, G, hd)).astype(np.float32),
            rng.standard_normal((B, S, K, hd)).astype(np.float32),
            rng.standard_normal((B, S, K, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,G,hd,window,pos,block_s", CASES)
def test_decode_plain_matches_reference(B, S, K, G, hd, window, pos,
                                        block_s, dtype):
    q, k, v = _inputs(B, S, K, G, hd, S + pos)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    # bfloat16 inputs: both sides round the same float32 draws
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = decode_attention_ref(tq, tk, tv, pos, window)
    assert got.dtype == tdt and got.shape == (B, K, G, hd)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    want_ref = jax_decode(jq, jk, jv, jnp.int32(pos), window=window,
                          use_pallas=False)
    want_pal = jax_decode(jq, jk, jv, jnp.int32(pos), window=window,
                          use_pallas=True, interpret=True, block_s=block_s)
    for want in (want_ref, want_pal):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_decode_plain_masks_future():
    """Values past pos do not change the output (the reference's
    test_decode_attention_masks_future), nor do those before a window."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 256, 2, 2, 64, 9))
    out = decode_attention_ref(q, k, v, 10)
    v2 = v.clone()
    v2[:, 64:] = 123.0
    k2 = k.clone()
    k2[:, 11:] = -7.0
    assert torch.equal(out, decode_attention_ref(q, k2, v2, 10))
    win = decode_attention_ref(q, k, v, 100, window=16)
    v3 = v.clone()
    v3[:, :85] = 55.0
    assert torch.equal(win, decode_attention_ref(q, k, v3, 100, window=16))


def test_decode_plain_fully_masked_is_uniform():
    """No valid position (pos < 0): the reference's -2^30 mask gives a
    uniform softmax over the whole cache, not NaN."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 2, 16, 4))
    out = decode_attention_ref(q, k, v, -1)
    want = jax_decode(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                      jnp.int32(-1), use_pallas=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(
        out, v.mean(dim=1)[:, :, None, :].expand_as(out), rtol=2e-5,
        atol=2e-5)


def test_decode_ops_dispatch_by_device():
    """A CPU tensor takes the plain version, and so does a ``meta`` one
    (shapes and dtypes only: the dry run traces there); any other device
    is an error."""
    from test_torch_dryrun import OtherDevice
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 32, 2, 1, 16, 1))
    want = decode_attention_ref(q, k, v, 7)
    assert torch.equal(ops.decode_attention(q, k, v, torch.tensor(7)), want)
    meta = ops.decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), 7)
    assert (meta.shape, meta.dtype, meta.is_meta) == \
        (want.shape, want.dtype, True)
    with pytest.raises(ValueError, match="device"):
        ops.decode_attention(*map(OtherDevice, (q, k, v)), 7)


# ---------------------------------------------- the CUDA kernel's algebra
LOG2E = 1.4426950408889634


def _split_mirror(q, k, v, pos, window=0, sms=132, blocks_per_sm=2,
                  warps=4, tile=16):
    """Plain-PyTorch mirror of ``csrc/decode_attention.cu``: the valid
    positions cut by ``split_plan`` (B K ceil(G / 8) groups on ``sms``
    SMs of ``blocks_per_sm`` blocks) into splits, none empty; in each
    split, warp w takes the split's tiles w, w + warps, ... of ``tile``
    positions (the ring's slots) and runs an online softmax in base 2 over
    them: the float32 scores q.k scaled by hd^-0.5 log2 e, one max and one
    rescale a tile; the block merges its warps' (m, l, acc) in warp order
    (a warp that saw no tile weighs nothing), and the splits' float32
    partials are merged by log-sum-exp in split order, 8 at a time (the
    running max and sums rescaled once a batch)."""
    from repro_torch.kernels.decode_attention.kernel import split_plan, \
        valid_range
    B, S, K, hd = k.shape
    G = q.shape[2]
    lo, hi, uniform = valid_range(S, pos, window)
    splits, L = split_plan(hi - lo + 1, B * K * -(-G // 8), sms,
                           blocks_per_sm)
    qscale = float(np.float32(hd ** -0.5)) * LOG2E
    qf = q.float()
    shape = q.shape[:3]

    def warp_pass(tiles):
        m = torch.full(shape, float("-inf"))
        l = torch.zeros(shape)
        acc = torch.zeros(q.shape, dtype=torch.float32)
        for t0, t1 in tiles:
            kt, vt = (x[:, t0:t1].float() for x in (k, v))
            s = torch.einsum("bkgh,btkh->bkgt", qf, kt) * qscale
            if uniform:
                s = torch.zeros_like(s)
            mn = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mn)
            p = torch.exp2(s - mn[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgt,btkh->bkgh",
                                                        p, vt)
            m = mn
        return m, l, acc

    parts = []
    for sp in range(splits):
        a, e = lo + sp * L, min(hi + 1, lo + (sp + 1) * L)
        starts = list(range(a, e, tile))
        ws = [warp_pass([(t, min(e, t + tile)) for t in starts[w::warps]])
              for w in range(warps)]
        ws = [x for x, t in zip(ws, range(warps)) if t < len(starts)]
        mx = torch.stack([m for m, _, _ in ws]).amax(0)
        lsum = torch.zeros_like(mx)
        acc = torch.zeros(q.shape, dtype=torch.float32)
        for m, l, a_ in ws:
            c = torch.exp2(m - mx)
            lsum = lsum + l * c
            acc = acc + a_ * c[..., None]
        parts.append((mx, lsum, acc))
    M = torch.full(shape, float("-inf"))
    lsum = torch.zeros(shape)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for b0 in range(0, splits, 8):           # the merge's batches of 8
        batch = parts[b0:b0 + 8]
        mn = torch.stack([M] + [m for m, _, _ in batch]).amax(0)
        r = torch.exp2(M - mn)
        lsum, out = lsum * r, out * r[..., None]
        for m, l, acc in batch:
            c = torch.exp2(m - mn)
            lsum = lsum + l * c
            out = out + acc * c[..., None]
        M = mn
    return (out / lsum.clamp_min(1e-30)[..., None]).to(q.dtype), splits


# (B, S, K, G, hd, window, pos, splits): the wrapper's plan on 132 SMs of
# 2 blocks (several splits, a ragged last split, one split), pos inside
# what would be the first split, a window cut into splits, the uniform
# case over several splits, G 8, hd 80; then plans of more than 8 splits
# (K 1 over 4,096 positions: 128), G exactly 2, 4 and 8 at hd 80, K 1, G
# above 8 (two blocks of query rows), and a window over tens of splits
SPLIT_CASES = [
    (2, 256, 2, 2, 64, 0, 255, 8),
    (1, 200, 2, 1, 64, 0, 199, 6),
    (2, 37, 2, 2, 16, 0, 36, 1),
    (1, 256, 2, 2, 64, 0, 10, 1),
    (1, 256, 2, 1, 128, 150, 200, 4),
    (1, 300, 2, 2, 16, 0, -1, 9),
    (1, 150, 1, 8, 80, 0, 149, 4),
    (1, 4096, 1, 1, 128, 0, 4095, 128),
    (1, 2048, 2, 2, 80, 0, 2047, 64),
    (1, 1024, 1, 4, 80, 0, 1000, 31),
    (2, 600, 1, 8, 80, 0, 599, 18),
    (1, 700, 1, 12, 64, 0, 650, 20),
    (1, 3000, 2, 2, 128, 1000, 2900, 31),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,G,hd,window,pos,splits", SPLIT_CASES)
def test_split_kv_mirror_matches_reference(B, S, K, G, hd, window, pos,
                                           splits, dtype):
    """The split-KV algebra the CUDA kernel runs, against the reference's
    jnp oracle at the reference's kernel tolerances."""
    q, k, v = _inputs(B, S, K, G, hd, S + pos + 1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got, n_splits = _split_mirror(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), pos, window)
    assert n_splits == splits
    want = jax_decode(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                      jnp.int32(pos), window=window, use_pallas=False)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("n,groups,sms", [
    (1055, 64, 132), (1, 64, 132), (129, 64, 132), (1000, 2, 132),
    (64, 1, 132), (100000, 1, 132), (500, 600, 132), (1055, 64, 114),
    (280, 2, 132), (4096, 16, 132), (20001, 64, 132), (8192, 64, 132),
    (2048, 32, 132), (4096, 1, 132), (31, 1, 132)])
def test_split_plan_covers_every_position(n, groups, sms):
    """Every valid position in exactly one split, no split empty, none
    shorter than MIN_SPLIT unless there is one, at most MAX_SPLITS, no
    more blocks than fit on the SMs at once, and the largest such count
    (the plan aims at the SMs: one more split would break a limit)."""
    from repro_torch.kernels.decode_attention.kernel import BLOCKS_PER_SM, \
        MAX_SPLITS, MIN_SPLIT, split_plan
    for bps in sorted({1, BLOCKS_PER_SM, 4}):
        splits, L = split_plan(n, groups, sms, bps)
        assert (splits - 1) * L < n <= splits * L
        covered = np.zeros(n, np.int64)
        for sp in range(splits):
            assert sp * L < min(n, (sp + 1) * L)        # none empty
            covered[sp * L:(sp + 1) * L] += 1
        assert (covered == 1).all()
        assert 1 <= splits <= MAX_SPLITS
        assert splits == 1 or L >= MIN_SPLIT
        assert splits == 1 or groups * splits <= bps * sms
        more = splits + 1
        assert (more > MAX_SPLITS or groups * more > bps * sms
                or n // more < MIN_SPLIT or -(-n // -(-n // more)) <= splits)
