"""Parity of the port's SSM serving path (``repro_torch.models`` SSD
layers, ``repro_torch.serve``, ``repro_torch.launch.serve``) with the JAX
reference, on ``mamba2-780m``'s reduced config (float32, 4 layers,
d_model 64, d_inner 128, 8 SSD heads of 16, state 16, chunk 16) with the
reference's own ``init_params`` weights carried across.

Tolerances, as for the OLMoE path (tests/test_torch_serve.py): single
layers 2e-5 and the whole model's logits and caches 1e-4 in float32 —
the same formulas on the CPU, with matrix products, sums and
transcendental functions from two libraries that round their last bit
differently; the scan's sums also run in another order (chunks in turn
against an associative scan).  Tokens (argmax over 256 logits) must be
equal.  bfloat16 layers use 4e-2, the reference's bfloat16 scan
tolerance.  Decode after prefill against the full forward's last logits
uses 2e-3, the reference's own bound (tests/test_models.py).
"""
import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import server as JS
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.launch.serve import serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import server as TS
from test_torch_serve import _close, _jax_init, _np_tree, _race_free

torch.set_num_threads(1)     # small tensors; leave the cores to XLA
ARCH = "mamba2-780m"
MAX_LEN = 64
DETERMINISTIC = ("A_log", "D", "conv_b", "ssm_norm")


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends.  Each holds
    memory mappings; a test worker that gathers more than the kernel's
    ``vm.max_map_count`` (65,530) crashes in a later XLA compile."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def params(cfgs):
    jp = _jax_init(cfgs[0], 0)
    return jp, model_params_from_jax(_np_tree(jp), "cpu")


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["blocks"][0])["ssm"],
            TM._unstack(tp["blocks"][0])[0]["ssm"])


def _cast(jtree, ttree, dtype):
    """The layer's matrices in ``dtype``; the float32 leaves (conv
    weights, A_log, D, dt_bias, norm) stay float32, as in a bfloat16
    model."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    mats = ("in_proj", "out_proj")
    return ({k: (v.astype(jdt) if k in mats else v) for k, v in jtree.items()},
            {k: (v.to(tdt) if k in mats else v) for k, v in ttree.items()})


# ------------------------------------------------------------------ config
def test_config_matches_reference(cfgs):
    """Every field the port keeps equals the reference's, for the full
    and the reduced config, and so do the SSM properties, the layer
    plans and the block decomposition."""
    for full in (True, False):
        j = jax_get_config(ARCH) if full else cfgs[0]
        t = get_config(ARCH) if full else cfgs[1]
        for f in t.__dataclass_fields__:
            assert getattr(t, f) == getattr(j, f), f
        assert (t.d_inner, t.ssm_heads) == (j.d_inner, j.ssm_heads)
        assert t.plan_blocks() == j.plan_blocks()
        assert [(s.kind, s.moe, s.window) for s in t.layer_plan()] == \
            [(s.kind, s.moe, s.window) for s in j.layer_plan()]
    full = get_config(ARCH)
    assert full.plan_blocks() == (0, 1, 48, 0)
    assert (full.d_inner, full.ssm_heads, full.ssm_state, full.ssm_chunk,
            full.ssm_conv) == (3072, 48, 128, 256, 4)
    assert (cfgs[1].ssm_heads, cfgs[1].ssm_headdim, cfgs[1].ssm_state,
            cfgs[1].ssm_chunk) == (8, 16, 16, 16)


def test_init_params_layout_matches_reference(cfgs, params):
    """The port's own random init has the reference's tree, shapes,
    dtypes and scales (std within 10% on the larger matrices); the
    deterministic leaves are equal; dt_bias lies in the reference's
    range."""
    jp, _ = params
    tp = TM.init_params(cfgs[1], torch.Generator().manual_seed(0),
                        device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, tp,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
        if a.size >= 4096:
            sa, sb = float(np.std(np.asarray(a))), float(b.std())
            assert abs(sa - sb) <= 0.1 * sa, (path, sa, sb)
    js, ts = jp["blocks"][0]["ssm"], tp["blocks"][0]["ssm"]
    for k in DETERMINISTIC:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]), k)
    for k in ("ln1",):
        np.testing.assert_array_equal(tp["blocks"][0][k].numpy(),
                                      np.asarray(jp["blocks"][0][k]))
    lo, hi = np.log(np.expm1(1e-3)), np.log(np.expm1(1e-1))
    assert bool(((ts["dt_bias"] >= lo - 1e-5)
                 & (ts["dt_bias"] <= hi + 1e-5)).all())


def test_full_width_a_log_matches_reference():
    """At full width (48 heads) the port's ``A_log`` is the reference's
    float32 linspace bit for bit and its log within 1 ulp: XLA's float32
    log and torch's round differently on one of the 48 points."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    ja = np.asarray(jax.jit(lambda: JM._ssm_params(
        jcfg, jax.random.key(0), jnp.bfloat16)["A_log"])())
    ta = TM._ssm_params(tcfg, TM._Init(torch.Generator().manual_seed(0),
                                       torch.device("cpu")),
                        torch.bfloat16)["A_log"].numpy()
    np.testing.assert_array_equal(
        TM._linspace32(1.0, 16.0, 48).numpy(),
        np.asarray(jax.jit(lambda: jnp.linspace(1.0, 16.0, 48))()))
    np.testing.assert_array_max_ulp(ta, ja, maxulp=1)


def test_bf16_params_carry_across_exactly(cfgs):
    """bfloat16 matrices arrive as torch.bfloat16 with the same values;
    the float32 SSM leaves stay float32 and equal."""
    jcfg = dataclasses.replace(cfgs[0], param_dtype="bfloat16")
    jp = _np_tree(_jax_init(jcfg, 1))
    tp = model_params_from_jax(jp, "cpu")
    js, ts = jp["blocks"][0]["ssm"], tp["blocks"][0]["ssm"]
    for k in ("in_proj", "out_proj"):
        assert ts[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(ts[k].float().numpy(),
                                      js[k].astype(np.float32))
    for k in ("conv_w", "dt_bias") + DETERMINISTIC:
        assert ts[k].dtype == torch.float32, k
        np.testing.assert_array_equal(ts[k].numpy(), js[k])


# ------------------------------------------------------------------ layers
def test_softplus_matches_jax_elementwise():
    """The port's softplus against ``jax.nn.softplus`` at every float32
    point of a grid over [-30, 30], across torch's F.softplus threshold
    of 20."""
    x = np.linspace(-30.0, 30.0, 200_001).astype(np.float32)
    x = np.concatenate([x, np.float32([19.999, 20.0, 20.001, 0.0, -0.0])])
    want = np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x)))
    got = TL.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d(cfgs, params, dtype):
    js, ts = _layer0(*params)
    x = np.random.default_rng(1).standard_normal((2, 11, 160)) \
        .astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(JL.causal_conv1d)(jnp.asarray(x, jdt), js["conv_w"],
                                     js["conv_b"])
    got = TL.causal_conv1d(torch.from_numpy(x).to(tdt), ts["conv_w"],
                           ts["conv_b"])
    assert got.dtype == tdt
    _close(got, want, 4e-2 if dtype == "bfloat16" else 2e-5)


@pytest.mark.parametrize("dtype,S", [("float32", 9), ("float32", 40),
                                     ("bfloat16", 40)])
def test_ssd_block(cfgs, params, dtype, S):
    """Prefill block: out, the conv tail and the final state; S 40 at
    chunk 16 runs two whole chunks and a partial one."""
    jcfg, tcfg = cfgs
    js, ts = _cast(*_layer0(*params), dtype)
    x = np.random.default_rng(2).standard_normal((2, S, 64)) \
        .astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout, (jtail, jst) = jax.jit(functools.partial(JL.ssd_block, cfg=jcfg))(
        js, x=jnp.asarray(x, jdt))
    tout, (ttail, tst) = TL.ssd_block(ts, tcfg, torch.from_numpy(x).to(tdt))
    assert tout.dtype == ttail.dtype == tdt and tst.dtype == torch.float32
    tol = 4e-2 if dtype == "bfloat16" else 2e-5
    _close(tout, jout, tol, "out")
    _close(ttail, jtail, tol, "conv_tail")
    _close(tst, jst, tol, "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode(cfgs, params, dtype):
    jcfg, tcfg = cfgs
    js, ts = _cast(*_layer0(*params), dtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 160)).astype(np.float32)
    ssm = (rng.standard_normal((2, 8, 16, 16)) * 0.5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jconv, jssm = jax.jit(functools.partial(JL.ssd_decode, cfg=jcfg))(
        js, x=jnp.asarray(x, jdt), conv_state=jnp.asarray(conv, jdt),
        ssm_state=jnp.asarray(ssm))
    tout, tconv, tssm = TL.ssd_decode(ts, tcfg, torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(conv).to(tdt),
                                      torch.from_numpy(ssm))
    assert tout.dtype == tconv.dtype == tdt and tssm.dtype == torch.float32
    tol = 4e-2 if dtype == "bfloat16" else 2e-5
    _close(tout, jout, tol, "out")
    _close(tconv, jconv, tol, "conv")
    _close(tssm, jssm, tol, "ssm")


# ------------------------------------------------------------------ model
def _prefill_both(cfgs, params, S):
    jcfg, tcfg = cfgs
    jp, tp = params
    toks = (np.arange(S, dtype=np.int32) * 29 % 256)[None, :]
    jlog, jcache = jax.jit(functools.partial(
        JM.prefill, cfg=jcfg, max_len=MAX_LEN, scan_layers=False))(
        jp, batch={"tokens": jnp.asarray(toks)})
    tlog, tcache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              max_len=MAX_LEN)
    return jlog, jcache, tlog, tcache


@pytest.fixture(scope="module")
def prefilled(cfgs, params):
    return _prefill_both(cfgs, params, 8)


@pytest.mark.parametrize("S", [8, 40])
def test_prefill_logits_and_cache(cfgs, params, prefilled, S):
    """An 8-token prompt (one partial chunk) and a 40-token one (two
    whole chunks and a partial one): last logits, conv windows and
    float32 states."""
    jlog, jcache, tlog, tcache = prefilled if S == 8 \
        else _prefill_both(cfgs, params, S)
    assert tlog.shape == (1, 1, 256)
    _close(tlog, jlog, 1e-4, "logits")
    assert len(tcache["blocks"]) == 1 and not tcache["head"] \
        and not tcache["tail"]
    blk = tcache["blocks"][0]
    assert tuple(blk["conv"].shape) == (4, 1, 3, 160)
    assert tuple(blk["ssm"].shape) == (4, 1, 8, 16, 16)
    assert blk["ssm"].dtype == torch.float32
    for kk in ("conv", "ssm"):
        _close(blk[kk], jcache["blocks"][0][kk], 1e-4, kk)


def test_cache_specs_match_reference(cfgs):
    jspec = JM.cache_specs(cfgs[0], 3, MAX_LEN)
    tspec = TM.cache_specs(cfgs[1], 3, MAX_LEN)
    for kk in ("conv", "ssm"):
        j = jspec["blocks"][0][kk]
        shape, dt = tspec["blocks"][0][kk]
        assert tuple(j.shape) == shape
        assert str(j.dtype) == str(dt).replace("torch.", "")


def test_decode_step_logits_and_cache(cfgs, params, prefilled):
    """Both sides start from the reference's cache and token; the port
    updates the cache in place."""
    jcfg, tcfg = cfgs
    jp, tp = params
    jlog0, jcache, _, _ = prefilled
    tcache = {key: [{kk: torch.from_numpy(np.array(v)) for kk, v in e.items()}
                    for e in jcache[key]] for key in jcache}
    tok = np.array(jnp.argmax(jlog0[:, -1], -1), np.int32)[:, None]
    jlog, jcache2 = jax.jit(functools.partial(JM.decode_step, cfg=jcfg))(
        jp, cache=jcache, tokens=jnp.asarray(tok), pos=jnp.int32(8))
    tlog, tcache2 = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok), 8)
    assert tcache2 is tcache
    _close(tlog, jlog, 1e-4, "logits")
    for kk in ("conv", "ssm"):
        _close(tcache2["blocks"][0][kk], jcache2["blocks"][0][kk], 1e-4, kk)


def test_decode_matches_forward(cfgs, params):
    """tests/test_models.py's test_ssm_decode_matches_forward on the
    port: prefill 15 tokens, decode the 16th, against the full forward's
    last logits."""
    tcfg = cfgs[1]
    tp = params[1]
    S = 16
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (1, S)).astype(np.int32))
    full, _ = TM.forward(tp, tcfg, {"tokens": tokens})
    _, cache = TM.prefill(tp, tcfg, {"tokens": tokens[:, :S - 1]},
                          max_len=S + 2)
    dec, _ = TM.decode_step(tp, tcfg, cache, tokens[:, S - 1:], S - 1)
    _close(dec[:, 0], full[:, -1].numpy(), 2e-3)


# ------------------------------------------------------------------ server
def test_server_tokens_match_reference(cfgs, params):
    """3 requests of 20 tokens (a whole chunk and a partial one) over 2
    slots: the same tokens per request as the reference Server on the
    same weights, its decode handed a copy of the output counts
    (``_race_free``: the reference race of ROADMAP Queue 3)."""
    jcfg, tcfg = cfgs
    jp, tp = params
    jsrv = _race_free(JS.Server(jcfg, jp, max_len=MAX_LEN, batch_slots=2))
    tsrv = TS.Server(tcfg, tp, max_len=MAX_LEN, batch_slots=2, device="cpu")

    def reqs(mod):
        return [mod.Request(rid=r, max_new=4,
                            prompt=(np.arange(20, dtype=np.int32) * 7 + r)
                            % 256) for r in range(3)]
    jreq, treq = reqs(JS), reqs(TS)
    for a, b in zip(jreq, treq):
        jsrv.submit(a)
        tsrv.submit(b)
    jdone, tdone = jsrv.drain(), tsrv.drain()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out for r in treq] == [r.out for r in jreq]
    assert all(len(r.out) == 4 for r in treq)


# ------------------------------------------------------------------ launch
def test_launch_serve_counts():
    """The launcher on the CPU at the chip run's request shape (8
    requests, 32 new tokens, 4 slots; 16-token prompts here): every
    request gets 32 tokens, 8 prefills and 62 decode steps, the counts
    the chip run's launch checks are built from."""
    rep = serve(ARCH, requests=8, prompt_len=16, max_new=32, slots=4,
                device="cpu")
    assert rep.cfg.name == ARCH and rep.cfg.ssm_state == 16
    assert rep.served == 8 and all(len(r.out) == 32 for r in rep.requests)
    assert rep.prefills == 8 and rep.decode_steps == 62
    assert sorted(rep.ttft_s) == list(range(8))
    assert rep.metrics()["output_tokens"] == 256
    assert torch.isfinite(rep.server.last_logits).all()
    assert all(0 <= t < 256 for r in rep.requests for t in r.out)
