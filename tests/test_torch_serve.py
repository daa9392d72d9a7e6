"""Parity of the port's serving path (``repro_torch.models``,
``repro_torch.serve``, ``repro_torch.launch.serve``) with the JAX
reference, on ``olmoe-1b-7b``'s reduced config (float32, 4 layers,
d_model 64, 4 query / 2 kv heads, 8 experts top-2) with the reference's
own ``init_params`` weights carried across.

Tolerances: single layers 2e-5, and the whole model's logits 1e-4.  The
two sides run the same float32 formulas on the CPU, but the matrix
products, softmax sums and transcendental functions come from two
libraries that sum in other orders and round their last bit
differently; a layer stays within a few ulps of its input scale, and
four layers of that compound.  Tokens (argmax over 256 logits) must be
equal.  bfloat16 cases (``moe_dense``, ``attention_decode``) hold the
hazards of mixed-type products and of where the decode probabilities
are cast; they use 3e-2, the reference's bfloat16 kernel tolerance.

The JAX functions are jitted once per module (fixtures), so each
compiles once.
"""
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

torch.set_num_threads(1)     # small tensors; leave the cores to XLA
ARCH = "olmoe-1b-7b"
MAX_LEN = 48


@pytest.fixture(scope="module", autouse=True)
def _release_jax_programs():
    """Drop this module's compiled JAX programs when it ends.  Each holds
    memory mappings; a test worker that gathers more than the kernel's
    ``vm.max_map_count`` (65,530) crashes in a later XLA compile."""
    yield
    jax.clear_caches()
    gc.collect()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


def _jax_init(cfg, seed):
    return jax.jit(JM.init_params, static_argnums=0)(cfg,
                                                     jax.random.key(seed))


@pytest.fixture(scope="module")
def params(cfgs):
    jcfg, _ = cfgs
    jp = _jax_init(jcfg, 0)
    return jp, model_params_from_jax(_np_tree(jp), "cpu")


def _layer0(jp, tp):
    jl = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    tl = TM._unstack(tp["blocks"][0])[0]
    return jl, tl


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


# ------------------------------------------------------------------ config
def test_config_matches_reference(cfgs):
    """Every field the port keeps equals the reference's, for the full
    and the reduced config, and the layer plans agree."""
    for full in (True, False):
        j = jax_get_config(ARCH) if full else cfgs[0]
        t = get_config(ARCH) if full else cfgs[1]
        for f in t.__dataclass_fields__:
            assert getattr(t, f) == getattr(j, f), f
        assert t.plan_blocks() == j.plan_blocks()
        assert [(s.kind, s.moe, s.window) for s in t.layer_plan()] == \
            [(s.kind, s.moe, s.window) for s in j.layer_plan()]
    assert get_config(ARCH).plan_blocks() == (0, 1, 16, 0)


def test_init_params_layout_matches_reference(cfgs, params):
    """The port's own random init has the reference's tree, shapes,
    dtypes and scales (std within 10% on the larger matrices)."""
    jp, _ = params
    gen = torch.Generator().manual_seed(0)
    tp = TM.init_params(cfgs[1], gen, device="cpu")
    jl, tl = jax.tree_util.tree_flatten_with_path(jp)[0], \
        jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t, tp,
                         is_leaf=lambda x: isinstance(x, torch.Tensor)))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
        if a.size >= 4096:
            sa, sb = float(np.std(np.asarray(a))), float(b.std())
            assert abs(sa - sb) <= 0.1 * sa, (path, sa, sb)


def test_bf16_params_carry_across_exactly(cfgs):
    """bfloat16 leaves (ml_dtypes in numpy) arrive as torch.bfloat16 with
    the same values; the float32 router stays float32."""
    jcfg = cfgs[0].__class__(**{**cfgs[0].__dict__,
                                "param_dtype": "bfloat16"})
    jp = _np_tree(_jax_init(jcfg, 1))
    tp = model_params_from_jax(jp, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["blocks"][0]["moe"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  jp["embed"].astype(np.float32))


# ------------------------------------------------------------------ layers
def test_rms_norm_and_rope(cfgs):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jax.jit(JL.rms_norm)(jnp.asarray(x), jnp.asarray(scale)), 2e-5)
    pos = np.tile(np.arange(5, dtype=np.int32) * 37, (2, 1))
    _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           jax.jit(JL.rope, static_argnums=2)(
               jnp.asarray(x), jnp.asarray(pos), 10_000.0), 2e-5)


def test_attention_prefill(cfgs, params):
    jcfg, tcfg = cfgs
    jl, tl = _layer0(*params)
    x = np.random.default_rng(1).standard_normal((2, 9, 64)) \
        .astype(np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    jout, (jk, jv) = jax.jit(functools.partial(
        JL.attention, cfg=jcfg, return_kv=True))(
        jl["attn"], x=jnp.asarray(x), positions=jnp.asarray(pos))
    tout, (tk, tv) = TL.attention(tl["attn"], tcfg, torch.from_numpy(x),
                                  torch.from_numpy(pos), return_kv=True)
    _close(tout, jout, 2e-5, "out")
    _close(tk, jk, 2e-5, "k")
    _close(tv, jv, 2e-5, "v")


@pytest.mark.parametrize("dtype,window", [("float32", 0), ("float32", 4),
                                          ("bfloat16", 0)])
def test_attention_decode(cfgs, params, dtype, window):
    """The decode layer with the kernel's plain version inside; the cache
    is written in place at pos."""
    jcfg, tcfg = cfgs
    jl, tl = _layer0(*params)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    ck = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    pos = 9
    jp_ = jax.tree.map(lambda a: a.astype(jdt) if a.ndim == 2 else a,
                       jl["attn"])
    tp_ = {k: (v.to(tdt) if v.dim() == 2 else v)
           for k, v in tl["attn"].items()}
    jout, jck, jcv = jax.jit(functools.partial(
        JL.attention_decode, cfg=jcfg, window=window))(
        jp_, x=jnp.asarray(x, jdt), cache_k=jnp.asarray(ck, jdt),
        cache_v=jnp.asarray(cv, jdt), pos=jnp.int32(pos))
    tck, tcv = torch.from_numpy(ck).to(tdt), torch.from_numpy(cv).to(tdt)
    tout, rck, rcv = TL.attention_decode(
        tp_, tcfg, torch.from_numpy(x).to(tdt), tck, tcv, pos,
        window=window)
    assert rck is tck and rcv is tcv and tout.dtype == tdt
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    _close(tout, jout, tol, "out")
    _close(tck, jck, tol, "cache_k")
    _close(tcv, jcv, tol, "cache_v")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_dense(cfgs, params, dtype):
    """Every expert for every token, the top 2 kept; in bfloat16 the
    float32 router meets bfloat16 activations (JAX promotes, torch needs
    the cast)."""
    jcfg, tcfg = cfgs
    jl, tl = _layer0(*params)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(3).standard_normal((2, 7, 64)) \
        .astype(np.float32)
    jm = {k: (v if k == "router" else v.astype(jdt))
          for k, v in jl["moe"].items()}
    tm = {k: (v if k == "router" else v.to(tdt))
          for k, v in tl["moe"].items()}
    jout = jax.jit(functools.partial(JL.moe_dense, cfg=jcfg))(
        jm, x=jnp.asarray(x, jdt))
    tout = TL.moe_dense(tm, tcfg, torch.from_numpy(x).to(tdt))
    assert tout.dtype == tdt
    _close(tout, jout, 3e-2 if dtype == "bfloat16" else 2e-5)


def test_moe_dense_takes_combine_weights_from_router(cfgs, params,
                                                     monkeypatch):
    """``moe_dense`` asks the router once for its dense combine weights
    in x's dtype (one launch on the card), for every token at once."""
    from repro_torch.kernels.moe_route import ops as route_ops
    _, tcfg = cfgs
    _, tl = _layer0(*params)
    calls = []
    real = route_ops.route_dense

    def spy(logits, k, renormalize, dtype):
        calls.append((tuple(logits.shape), k, renormalize, dtype))
        return real(logits, k, renormalize, dtype)
    monkeypatch.setattr(route_ops, "route_dense", spy)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 64)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        tm = {k: (v if k == "router" else v.to(dt))
              for k, v in tl["moe"].items()}
        assert TL.moe_dense(tm, tcfg, x.to(dt)).dtype == dt
    k = tcfg.num_experts_per_tok
    assert calls == [((6, tcfg.num_experts), k, tcfg.moe_renormalize, dt)
                     for dt in (torch.float32, torch.bfloat16)]


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def prefilled(cfgs, params):
    """Reference and port prefill of one 8-token prompt."""
    jcfg, tcfg = cfgs
    jp, tp = params
    toks = (np.arange(8, dtype=np.int32) * 29 % 256)[None, :]
    jlog, jcache = jax.jit(functools.partial(
        JM.prefill, cfg=jcfg, max_len=MAX_LEN, scan_layers=False))(
        jp, batch={"tokens": jnp.asarray(toks)})
    tlog, tcache = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              max_len=MAX_LEN)
    return jlog, jcache, tlog, tcache


def test_prefill_logits_and_cache(prefilled):
    jlog, jcache, tlog, tcache = prefilled
    assert tlog.shape == (1, 1, 256)
    _close(tlog, jlog, 1e-4, "logits")
    assert len(tcache["blocks"]) == 1 and not tcache["head"] \
        and not tcache["tail"]
    for kk in ("k", "v"):
        assert tuple(tcache["blocks"][0][kk].shape) == (4, 1, MAX_LEN, 2, 16)
        _close(tcache["blocks"][0][kk], jcache["blocks"][0][kk], 1e-4, kk)


def test_decode_step_logits_and_cache(cfgs, params, prefilled):
    jcfg, tcfg = cfgs
    jp, tp = params
    jlog0, jcache, _, _ = prefilled
    # both sides start from the reference's cache and token
    tcache = {key: [{kk: torch.from_numpy(np.array(v)) for kk, v in e.items()}
                    for e in jcache[key]] for key in jcache}
    tok = np.array(jnp.argmax(jlog0[:, -1], -1), np.int32)[:, None]
    jlog, jcache2 = jax.jit(functools.partial(JM.decode_step, cfg=jcfg))(
        jp, cache=jcache, tokens=jnp.asarray(tok), pos=jnp.int32(8))
    tlog, tcache2 = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok), 8)
    assert tcache2 is tcache                     # updated in place
    _close(tlog, jlog, 1e-4, "logits")
    for kk in ("k", "v"):
        _close(tcache2["blocks"][0][kk], jcache2["blocks"][0][kk], 1e-4, kk)


# ------------------------------------------------------------------ server
def _requests(mod, n=3, max_new=4):
    return [mod.Request(rid=r, prompt=np.arange(8, dtype=np.int32) + r,
                        max_new=max_new) for r in range(n)]


def _race_free(jsrv):
    """The reference ``Server.step`` passes ``jnp.asarray(self._n_out)``
    to its asynchronously dispatched decode and then increments
    ``self._n_out`` in place.  On the CPU backend ``jnp.asarray`` of an
    int32 numpy array may share the host buffer, so the device can read
    the already-incremented counts: tokens then land one slot late with
    zeros between them, in some runs and not others (ROADMAP Queue 3).
    The decode is handed a copy here; nothing else changes."""
    decode = jsrv._decode
    jsrv._decode = lambda p, c, t, pos, buf, n_out: decode(
        p, c, t, pos, buf, jnp.array(np.array(n_out)))
    return jsrv


def test_server_tokens_match_reference(cfgs, params):
    """3 requests over 2 slots (tests/test_runtime.py's shape): the same
    tokens per request as the reference Server on the same weights."""
    jcfg, tcfg = cfgs
    jp, tp = params
    jsrv = _race_free(JS.Server(jcfg, jp, max_len=MAX_LEN, batch_slots=2))
    tsrv = TS.Server(tcfg, tp, max_len=MAX_LEN, batch_slots=2, device="cpu")
    jreq, treq = _requests(JS), _requests(TS)
    for a, b in zip(jreq, treq):
        jsrv.submit(a)
        tsrv.submit(b)
    jdone, tdone = jsrv.drain(), tsrv.drain()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out for r in treq] == [r.out for r in jreq]
    assert all(len(r.out) == 4 for r in treq)


def _tsrv(cfgs, params, **ing):
    return TS.Server(cfgs[1], params[1], max_len=MAX_LEN, batch_slots=1,
                     ingest=TS.IngestConfig(**ing), device="cpu")


def _req(rid, max_new=2):
    return TS.Request(rid=rid, max_new=max_new,
                      prompt=np.arange(8, dtype=np.int32) + rid)


def _dedup(cfgs, params):
    srv = _tsrv(cfgs, params)
    a = srv.submit(_req(0), idempotency_key="k0")
    dup = srv.submit(_req(99), idempotency_key="k0")
    assert dup is a and len(srv.queue) == 1
    srv.drain()
    again = srv.submit(_req(99), idempotency_key="k0")
    assert again is a and again.done and len(again.out) >= 2
    assert len(srv.queue) == 0


def _dedup_window(cfgs, params):
    srv = _tsrv(cfgs, params, dedup_window=2, max_queue=0)
    first = srv.submit(_req(0), idempotency_key="k0")
    srv.submit(_req(1), idempotency_key="k1")
    srv.submit(_req(2), idempotency_key="k2")          # evicts k0
    fresh = srv.submit(_req(3), idempotency_key="k0")
    assert fresh is not first and len(srv.queue) == 4


def _queue_full(cfgs, params):
    srv = _tsrv(cfgs, params, max_queue=2)
    srv.submit(_req(0))
    srv.submit(_req(1))
    with pytest.raises(TS.QueueFull) as exc:
        srv.submit(_req(2))
    assert isinstance(exc.value, TS.ServeError)
    assert exc.value.kind == "queue_full"


def _retry_succeeds(cfgs, params):
    srv = _tsrv(cfgs, params, max_queue=1)
    srv.submit(_req(0))
    waited = []

    def drain_a_bit(s):
        waited.append(s)
        srv.step()

    got = srv.submit_with_retry(_req(1), sleep=drain_a_bit)
    assert got.rid == 1 and len(waited) >= 1


def _retries_exhausted(cfgs, params):
    """The backoff schedule equals the reference Server's, draw for
    draw (same rid-seeded jitter)."""
    ing = dict(max_queue=1, max_retries=3, backoff_base_s=0.1,
               backoff_cap_s=0.25, jitter_frac=0.2)
    srv = _tsrv(cfgs, params, **ing)
    srv.submit(_req(0))
    waited = []
    with pytest.raises(TS.RetriesExhausted) as exc:
        srv.submit_with_retry(_req(1), sleep=waited.append)
    err = exc.value
    assert err.kind == "retries_exhausted"
    assert err.attempts == 3 and err.backoffs == waited
    for b, nominal in zip(waited, (0.1, 0.2, 0.25)):
        assert nominal * 0.8 <= b <= nominal * 1.2
    jsrv = JS.Server(cfgs[0], params[0], max_len=MAX_LEN, batch_slots=1,
                     ingest=JS.IngestConfig(**ing))
    jsrv.submit(JS.Request(rid=0, prompt=np.arange(8, dtype=np.int32)))
    jwaited = []
    with pytest.raises(JS.RetriesExhausted):
        jsrv.submit_with_retry(
            JS.Request(rid=1, prompt=np.arange(8, dtype=np.int32)),
            sleep=jwaited.append)
    assert waited == jwaited


def _timeout(cfgs, params):
    srv = _tsrv(cfgs, params, timeout_ticks=4)
    served = srv.submit(_req(0, max_new=4))
    starved = srv.submit(_req(1, max_new=4))          # 1 slot: queued
    done = srv.drain()
    assert served.done and served.error is None
    assert starved.done and isinstance(starved.error, TS.RequestTimeout)
    assert starved.error.kind == "timeout"
    assert {r.rid for r in done} == {0, 1}


@pytest.mark.parametrize("case", [_dedup, _dedup_window, _queue_full,
                                  _retry_succeeds, _retries_exhausted,
                                  _timeout], ids=lambda f: f.__name__[1:])
def test_ingest(cfgs, params, case):
    """tests/test_runtime.py's admission-control cases on the port."""
    case(cfgs, params)


# ------------------------------------------------------------------ launch
def test_launch_serve_counts(cfgs):
    """The launcher's function on the CPU: every request gets max_new
    tokens; a prefill per request and the tick count the chip run's
    launch counts are built from (4 slots, 8 requests, 31 decode steps
    per wave of 4)."""
    rep = serve(ARCH, requests=8, prompt_len=16, max_new=32, slots=4,
                device="cpu")
    assert rep.served == 8 and all(len(r.out) == 32 for r in rep.requests)
    assert rep.prefills == 8 and rep.decode_steps == 62
    assert rep.server.max_len == 16 + 32 + 8
    assert sorted(rep.ttft_s) == list(range(8))
    m = rep.metrics()
    assert m["output_tokens"] == 256 and m["output_tokens_per_s"] > 0
    assert torch.isfinite(rep.server.last_logits).all()


def test_entry_points_default_to_cuda(cfgs, params):
    """device=None means CUDA: without it every entry point raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TS.Server(cfgs[1], params[1], max_len=MAX_LEN)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_params(cfgs[1], torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        model_params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        serve(ARCH)
