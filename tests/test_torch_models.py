"""Parity of the port's dense, sliding-window, prefix-LM and
encoder-decoder model paths (``repro_torch.configs``,
``repro_torch.models``, ``repro_torch.serve``) with the JAX reference,
on the reduced configs of the eight architectures the OLMoE and mamba2
files do not cover: ``qwen3-0.6b`` (QK-norm), ``h2o-danube-1.8b``
(window on every layer), ``gemma3-27b`` (local:global windows),
``paligemma-3b`` (a bidirectional vision prefix, MQA, GELU),
``whisper-base`` (an encoder and cross-attention), ``jamba-v0.1-52b``
(attention, SSD and MoE), ``llama3-405b`` and ``kimi-k2-1t-a32b`` (a
dense head layer, then MoE), each with the reference's own
``init_params`` weights carried across.

The reference's ``decode_step`` runs its superblocks out of depth
order when the period and the superblock count both exceed 1 (reduced
gemma3: 2 x 2; ROADMAP Queue 3); the port decodes in depth order.  So
the port's decode is held to the reference's own ``decode_step`` on the
same model laid out one layer per block (``_one_layer_blocks``), where
that loop is depth order.

Tolerances, as in tests/test_torch_serve.py: single layers 2e-5 and the
whole model's logits and caches 1e-4 in float32 (the same formulas, with
products and transcendental functions from two libraries that round
their last bit differently), 3e-2 in bfloat16 (the reference's bfloat16
kernel tolerance).  Server tokens must be equal.  Reduced windows are 16
positions, so the 20-token prompts here cut them in prefill and decode.

Each reference side runs inside the one test that needs it (module
fixtures are rebuilt on every test worker), and JAX's compiled programs
are dropped after every test.
"""
import dataclasses
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jax_get_config
from repro.configs.base import ArchConfig as JArchConfig
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import server as JS
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.launch.serve import serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import server as TS
from test_torch_serve import _close, _jax_init, _np_tree, _race_free

torch.set_num_threads(1)     # small tensors; leave the cores to XLA
NEW_ARCHS = ["qwen3-0.6b", "h2o-danube-1.8b", "gemma3-27b", "paligemma-3b",
             "whisper-base", "jamba-v0.1-52b", "llama3-405b",
             "kimi-k2-1t-a32b"]
S_TEXT = 20                  # text tokens: past the reduced window of 16
ENC_FRAMES = 16              # tests/test_models.py tiny_batch's frames


@pytest.fixture(autouse=True)
def _release_jax_programs():
    """Drop the test's compiled JAX programs when it ends.  Each holds
    memory mappings; a test worker that gathers more than the kernel's
    ``vm.max_map_count`` (65,530) crashes in a later XLA compile."""
    yield
    jax.clear_caches()
    gc.collect()


def _cfgs(arch, **over):
    return (jax_get_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def _params(jcfg):
    jp = _jax_init(jcfg, 0)
    return jp, model_params_from_jax(_np_tree(jp), "cpu")


def _torch_tree(tree):
    """A tree of tensors as JAX's tree utilities see it."""
    return jax.tree.map(lambda t: t, tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


def _close_tree(got, want, tol, what):
    """Every leaf of the port's tree within ``tol`` of the reference's,
    with the same paths."""
    gl = jax.tree_util.tree_flatten_with_path(_torch_tree(got))[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl], what
    for (path, g), (_, w) in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape), (what, path)
        _close(g, w, tol, f"{what}{jax.tree_util.keystr(path)}")


def _batch(cfg, B=2, S=S_TEXT, seed=0):
    """Seeded tokens, and tests/test_models.py ``tiny_batch``'s frontend
    stubs: every patch or frame embedding 0.01, 16 frames for audio."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = np.full(
            (B, cfg.num_prefix_tokens, cfg.d_model), 0.01, np.float32)
    if cfg.frontend == "audio_stub":
        batch["encoder_embeds"] = np.full((B, ENC_FRAMES, cfg.d_model), 0.01,
                                          np.float32)
    return batch


def _prefix(cfg):
    return cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0


@dataclasses.dataclass(frozen=True)
class _OneLayerBlocksCfg(JArchConfig):
    """A reference config whose every layer is its own block (no head or
    tail, one superblock): the reference's ``decode_step`` then visits
    the layers in depth order."""

    def plan_blocks(self):
        return 0, self.num_layers, 1, 0


def _layers(tree, cfg):
    """The per-layer subtrees of a params or cache tree, in depth
    order."""
    head, p, n_super, tail = cfg.plan_blocks()
    out = list(tree["head"])
    for s in range(n_super):
        for j in range(p):
            out.append(jax.tree.map(lambda a: a[s], tree["blocks"][j]))
    return out + list(tree["tail"])


def _one_layer_blocks(cfg, *trees):
    """``cfg`` as ``_OneLayerBlocksCfg`` and each params or cache tree
    laid out to match (a JAX or a torch tree; the encoder's blocks stay
    as they are)."""
    flat_cfg = _OneLayerBlocksCfg(**{f.name: getattr(cfg, f.name)
                                     for f in dataclasses.fields(cfg)})
    out = []
    for tree in trees:
        flat = dict(tree, head=[], tail=[])
        flat["blocks"] = [jax.tree.map(lambda a: a[None], layer)
                          for layer in _layers(tree, cfg)]
        out.append(flat)
    return (flat_cfg, *out)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_config_matches_reference(arch):
    """Every kept field, the layer and encoder plans, the block
    decomposition and the parameter counts equal the reference's, for
    the full config, the reduced one and a reduced one with a depth
    override."""
    for j, t in ((jax_get_config(arch), get_config(arch)),
                 _cfgs(arch), _cfgs(arch, num_layers=3)):
        for f in t.__dataclass_fields__:
            assert getattr(t, f) == getattr(j, f), f
        assert [dataclasses.astuple(s) for s in t.layer_plan()] == \
            [dataclasses.astuple(s) for s in j.layer_plan()]
        assert [dataclasses.astuple(s) for s in t.encoder_plan()] == \
            [dataclasses.astuple(s) for s in j.encoder_plan()]
        assert t.plan_blocks() == j.plan_blocks()
        assert t.param_counts() == j.param_counts()


def test_registry_holds_the_reference_archs():
    """All ten architectures, and the full-width facts this slice's chip
    run rests on: gemma3-27b is 27.0 B parameters (54.0 GB in bf16) in 10
    superblocks of 6 (five local layers of window 1,024, one global)
    and 2 local ones; the three that do not fit an 80 GB card."""
    assert sorted(ARCHS) == sorted(JARCHS)
    g = get_config("gemma3-27b")
    assert g.plan_blocks() == (0, 6, 10, 2)
    assert round(g.param_counts()[0] / 1e9, 1) == 27.0
    assert sum(s.window == 1024 for s in g.layer_plan()) == 52
    too_big = {n for n, c in ARCHS.items() if 2 * c.param_counts()[0] > 80e9}
    assert too_big == {"jamba-v0.1-52b", "llama3-405b", "kimi-k2-1t-a32b"}


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_init_params_layout_matches_reference(arch):
    """The port's own random init has the reference's tree, shapes and
    dtypes for every reduced architecture (the reference's shapes from
    ``abstract_params``, so nothing is compiled)."""
    jcfg, tcfg = _cfgs(arch)
    jl = jax.tree_util.tree_flatten_with_path(JM.abstract_params(jcfg))[0]
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tl = jax.tree_util.tree_flatten_with_path(_torch_tree(tp))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path


def test_stacked_init_draws_like_layer_by_layer():
    """A stacked leaf is filled row by row in place, drawing exactly
    what building each layer and stacking them draws (and the same
    scales): layer s of period position j is row s."""
    tcfg = get_config("gemma3-27b").reduced(num_layers=6)   # 3 x (2)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    gen = torch.Generator().manual_seed(3)
    ini = TM._Init(gen, torch.device("cpu"))
    embed = ini.dense((tcfg.vocab_size, tcfg.d_model), torch.float32,
                      0.02).draw()
    torch.testing.assert_close(tp["embed"], embed, rtol=0, atol=0)
    plan = tcfg.layer_plan()
    head, p, n_super, _ = tcfg.plan_blocks()
    assert (head, p, n_super) == (0, 2, 3)
    for j in range(p):
        rows = [TM._materialize(TM._layer_params(
            tcfg, plan[s * p + j], ini, torch.float32))
            for s in range(n_super)]
        want = TM._stack(rows)
        for path, a in jax.tree_util.tree_flatten_with_path(
                _torch_tree(want))[0]:
            b = functools.reduce(lambda t, k: t[k.key], path,
                                 tp["blocks"][j])
            torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["whisper-base", "kimi-k2-1t-a32b",
                                  "h2o-danube-1.8b"])
def test_params_carry_across_unchanged(arch):
    """``model_params_from_jax`` walks any tree: ``lm_head``, the
    decoder's ``ln_x``/``cross``, ``enc_blocks`` and ``enc_final_norm``,
    kimi's dense head layer and MoE blocks arrive with the reference's
    paths, dtypes and values."""
    jcfg, _ = _cfgs(arch)
    jp = _np_tree(_jax_init(jcfg, 1))
    tp = model_params_from_jax(jp, "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(_torch_tree(tp))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
        np.testing.assert_array_equal(b.numpy(), a, str(path))
    keys = {jax.tree_util.keystr(p) for p, _ in tl}
    if arch == "whisper-base":
        assert {"['enc_final_norm']", "['blocks'][0]['cross']['wk']",
                "['blocks'][0]['ln_x']",
                "['enc_blocks'][0]['mlp']['wo_mlp']"} <= keys
    else:
        assert "['lm_head']" in keys


# ------------------------------------------------------------------ layers
def _layer0(tcfg):
    """Layer 0 of the port's own reduced init (seed 0), as a JAX tree
    and a torch tree holding the same values (a layer test needs equal
    weights, not the reference's draw)."""
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tl = TM._unstack(tp["blocks"][0])[0]
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tl), tl


def _cast_mats(jtree, ttree, dtype):
    """The 2-D matrices in ``dtype``; norms stay float32."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return ({k: (v.astype(jdt) if v.ndim == 2 else v)
             for k, v in jtree.items()},
            {k: (v.to(tdt) if v.dim() == 2 else v) for k, v in ttree.items()})


@pytest.mark.parametrize("case", ["swiglu_float32", "swiglu_bfloat16",
                                  "gelu_float32", "gelu_bfloat16",
                                  "gelu_elementwise"])
def test_mlp(case):
    """SwiGLU (qwen3) and GELU (paligemma) MLPs; ``gelu_elementwise``
    reads the activation itself through an identity output matrix, where
    the erf GELU is up to 4.7e-4 away from ``jax.nn.gelu``'s tanh form."""
    kind, dtype = case.split("_")
    arch = "qwen3-0.6b" if kind == "swiglu" else "paligemma-3b"
    jcfg, tcfg = _cfgs(arch)
    jl, tl = _layer0(tcfg)
    jm, tm = jl["mlp"], tl["mlp"]
    if dtype == "elementwise":
        dtype = "float32"
        ff = tcfg.d_ff
        jm = {"wi": jm["wi"], "wo_mlp": jnp.eye(ff, dtype=jnp.float32)}
        tm = {"wi": tm["wi"], "wo_mlp": torch.eye(ff)}
    jm, tm = _cast_mats(jm, tm, dtype)
    x = (np.random.default_rng(1).standard_normal((2, 7, 64)) * 3) \
        .astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(functools.partial(JL.mlp, cfg=jcfg))(
        jm, x=jnp.asarray(x, jdt))
    got = TL.mlp(tm, tcfg, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(got, want, 3e-2 if dtype == "bfloat16" else 2e-5)


ATTN_CASES = {
    # name: (arch, params, S, Sk, kwargs)
    "cross": ("whisper-base", "cross", 5, 7, dict(causal=False)),
    "cross_qk_norm": ("gemma3-27b", "attn", 5, 7, dict(causal=False)),
    "encoder": ("whisper-base", "attn", 9, 0, dict(causal=False)),
    "prefix": ("paligemma-3b", "attn", 12, 0, dict(prefix_len=8)),
    "window": ("gemma3-27b", "attn", 12, 0, dict(window=4)),
    "window_prefix": ("h2o-danube-1.8b", "attn", 12, 0,
                      dict(window=4, prefix_len=6)),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention(case):
    """Full-sequence attention: cross-attention through ``kv_override``
    (q norm only, no rope, key positions 0..Sk-1), the encoder's
    ``causal=False``, the bidirectional prefix, the window."""
    arch, which, S, Sk, kw = ATTN_CASES[case]
    jcfg, tcfg = _cfgs(arch)
    jl, tl = _layer0(tcfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    K, hd = tcfg.num_kv_heads, tcfg.head_dim
    jkw, tkw = dict(kw), dict(kw)
    if Sk:
        kv = [rng.standard_normal((2, Sk, K, hd)).astype(np.float32)
              for _ in range(2)]
        jkw["kv_override"] = tuple(jnp.asarray(a) for a in kv)
        tkw["kv_override"] = tuple(torch.from_numpy(a) for a in kv)
    else:
        jkw["return_kv"] = tkw["return_kv"] = True
    want = jax.jit(functools.partial(JL.attention, cfg=jcfg, **{
        k: v for k, v in jkw.items() if k != "kv_override"}))(
        jl[which], x=jnp.asarray(x), positions=jnp.asarray(pos),
        **({"kv_override": jkw["kv_override"]} if Sk else {}))
    got = TL.attention(tl[which], tcfg, torch.from_numpy(x),
                       torch.from_numpy(pos), **tkw)
    if Sk:
        _close(got, want, 2e-5, "out")
    else:
        _close(got[0], want[0], 2e-5, "out")
        _close(got[1][0], want[1][0], 2e-5, "k")
        _close(got[1][1], want[1][1], 2e-5, "v")


DECODE_CASES = {
    # name: (arch, params, dtype, window, cross)
    "cross_float32": ("whisper-base", "cross", "float32", 0, True),
    "cross_bfloat16": ("whisper-base", "cross", "bfloat16", 0, True),
    "cross_qk_norm": ("gemma3-27b", "attn", "float32", 0, True),
    "window_float32": ("h2o-danube-1.8b", "attn", "float32", 4, False),
    "window_bfloat16": ("h2o-danube-1.8b", "attn", "bfloat16", 4, False),
    "window_qk_norm": ("gemma3-27b", "attn", "float32", 4, False),
    "mqa_head_dim": ("paligemma-3b", "attn", "float32", 0, False),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_attention_decode(case):
    """The decode layer with the kernel's plain version inside.  Cross-
    attention reads all Sk keys and writes no cache; self-attention
    writes its K/V at pos in place and attends within the window."""
    arch, which, dtype, window, cross = DECODE_CASES[case]
    jcfg, tcfg = _cfgs(arch)
    jl, tl = _layer0(tcfg)
    jp_, tp_ = _cast_mats(jl[which], tl[which], dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    K, hd = tcfg.num_kv_heads, tcfg.head_dim
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    ck = rng.standard_normal((2, 16, K, hd)).astype(np.float32)
    cv = rng.standard_normal((2, 16, K, hd)).astype(np.float32)
    pos = 9
    jck, jcv = jnp.asarray(ck, jdt), jnp.asarray(cv, jdt)
    tck, tcv = torch.from_numpy(ck).to(tdt), torch.from_numpy(cv).to(tdt)
    jkw = {"cross_kv": (jck, jcv)} if cross else {}
    tkw = {"cross_kv": (tck, tcv)} if cross else {}
    jout, jck2, jcv2 = jax.jit(functools.partial(
        JL.attention_decode, cfg=jcfg, window=window))(
        jp_, x=jnp.asarray(x, jdt), cache_k=jck, cache_v=jcv,
        pos=jnp.int32(pos), **jkw)
    before = (tck.clone(), tcv.clone())
    tout, rck, rcv = TL.attention_decode(
        tp_, tcfg, torch.from_numpy(x).to(tdt), tck, tcv, pos,
        window=window, **tkw)
    assert rck is tck and rcv is tcv and tout.dtype == tdt
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    _close(tout, jout, tol, "out")
    _close(tck, jck2, tol, "cache_k")
    _close(tcv, jcv2, tol, "cache_v")
    if cross:
        assert torch.equal(tck, before[0]) and torch.equal(tcv, before[1])


def test_cross_decode_runs_the_decode_kernel_at_the_last_key(monkeypatch):
    """Cross-attention decode goes through ``decode_ops.decode_attention``
    (the kernel on the card) at pos Sk - 1 with no window, whatever the
    decoder's position."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    _, tcfg = _cfgs("whisper-base")
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    lp = TM._unstack(tp["blocks"][0])[0]
    calls = []
    real = decode_ops.decode_attention

    def spy(q, k, v, pos, window=0):
        calls.append((tuple(k.shape), pos, window))
        return real(q, k, v, pos, window)
    monkeypatch.setattr(decode_ops, "decode_attention", spy)
    kv = torch.randn(2, 11, 2, 16)
    TL.attention_decode(lp["cross"], tcfg, torch.randn(2, 1, 64), kv, kv, 3,
                        cross_kv=(kv, kv))
    assert calls == [((2, 11, 2, 16), 10, 0)]


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_model_matches_reference(arch):
    """Reduced, with the reference's weights: the forward's logits, the
    prefill's last logits and every cache entry (cross-attention K/V
    included), then one decode step's logits and cache from the
    reference's cache, each within 1e-4."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    batch = _batch(tcfg)
    P = _prefix(tcfg)
    max_len = P + S_TEXT + 8
    jlog, jcache = jax.jit(functools.partial(
        JM.forward, cfg=jcfg, collect_cache=True, max_len=max_len,
        scan_layers=False))(jp, batch={k: jnp.asarray(v)
                                       for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlog, _ = TM.forward(tp, tcfg, tb)
    assert tuple(tlog.shape) == (2, P + S_TEXT, 256)
    _close(tlog, jlog, 1e-4, "forward logits")
    plog, tcache = TM.prefill(tp, tcfg, tb, max_len=max_len)
    _close(plog, jlog[:, -1:], 1e-4, "prefill logits")
    _close_tree(tcache, jcache, 1e-4, "prefill cache")
    if tcfg.enc_dec:
        assert tuple(tcache["blocks"][0]["cross_k"].shape) == \
            (4, 2, ENC_FRAMES, 2, 16)
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    pos = P + S_TEXT
    fcfg, fp, fcache = _one_layer_blocks(jcfg, jp, jcache)
    jlog2, jcache2 = jax.jit(functools.partial(JM.decode_step, cfg=fcfg))(
        fp, cache=fcache, tokens=jnp.asarray(tok), pos=jnp.int32(pos))
    tcache = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jcache)
    tlog2, tcache2 = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok),
                                    pos)
    assert tcache2 is tcache
    _close(tlog2, jlog2, 1e-4, "decode logits")
    _close_tree(_one_layer_blocks(jcfg, tcache2)[1], jcache2, 1e-4,
                "decode cache")


@pytest.mark.parametrize("arch", ["gemma3-27b", "h2o-danube-1.8b",
                                  "paligemma-3b", "whisper-base"])
def test_decode_matches_forward(arch):
    """tests/test_models.py's teacher-forced check on the port: prefill
    all but the last text token, decode it, against the full forward's
    last logits (2e-3, the reference's bound), across the window and
    the vision prefix."""
    _, tcfg = _cfgs(arch)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(tcfg, B=1, seed=4).items()}
    full, _ = TM.forward(tp, tcfg, batch)
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    P = _prefix(tcfg)
    _, cache = TM.prefill(tp, tcfg, short, max_len=P + S_TEXT + 2)
    dec, _ = TM.decode_step(tp, tcfg, cache, batch["tokens"][:, -1:],
                            P + S_TEXT - 1)
    _close(dec[:, 0], full[:, -1].numpy(), 2e-3)


def test_reference_decode_runs_superblocks_out_of_order():
    """The fault the port does not copy (ROADMAP Queue 3): on reduced
    gemma3 (period 2, 2 superblocks) the reference's ``decode_step``
    disagrees with its own forward, teacher-forced, by far more than
    the reference's 2e-3 bound; laid out one layer per block, its own
    code agrees, and so does the port on the same weights."""
    jcfg, tcfg = _cfgs("gemma3-27b")
    assert jcfg.plan_blocks() == (0, 2, 2, 0)
    jp, tp = _params(jcfg)
    toks = jnp.asarray(_batch(tcfg, B=1, seed=4)["tokens"])
    full, _ = jax.jit(functools.partial(JM.forward, cfg=jcfg,
                                        scan_layers=False))(
        jp, batch={"tokens": toks})
    _, cache = jax.jit(functools.partial(
        JM.prefill, cfg=jcfg, max_len=S_TEXT + 2, scan_layers=False))(
        jp, batch={"tokens": toks[:, :-1]})
    pos = jnp.int32(S_TEXT - 1)

    def gap(cfg, p, c):
        dec, _ = jax.jit(functools.partial(JM.decode_step, cfg=cfg))(
            p, cache=c, tokens=toks[:, -1:], pos=pos)
        return float(jnp.abs(dec[:, 0] - full[:, -1]).max())
    assert gap(jcfg, jp, cache) > 0.1
    assert gap(*_one_layer_blocks(jcfg, jp, cache)) < 1e-4
    tcache = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), cache)
    tdec, _ = TM.decode_step(tp, tcfg, tcache,
                             torch.from_numpy(np.array(toks[:, -1:])),
                             S_TEXT - 1)
    _close(tdec[:, 0], full[:, -1], 1e-4, "port decode vs forward")


def test_bf16_model_matches_reference():
    """Reduced gemma3 in bfloat16 (windows, QK-norm, global layers): the
    forward's logits at every position, the prefill's first-layer cache
    and a decode step's logits within 3e-2.  Deeper cache entries sit
    downstream of the MLP's activation, which XLA's CPU backend rounds
    to bfloat16 after every step and the port once
    (``test_bf16_activation_rounding``): by depth 3 a few of them (1 of
    3,584) are a few bfloat16 steps apart, so the model is held by its
    logits there."""
    jcfg, tcfg = _cfgs("gemma3-27b", param_dtype="bfloat16")
    jp, tp = _params(jcfg)
    assert tp["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    batch = _batch(tcfg)
    max_len = S_TEXT + 8
    jlog, jcache = jax.jit(functools.partial(
        JM.forward, cfg=jcfg, collect_cache=True, max_len=max_len,
        scan_layers=False))(jp, batch={"tokens": jnp.asarray(
            batch["tokens"])})
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    tlog, _ = TM.forward(tp, tcfg, tb)
    assert tlog.dtype == torch.bfloat16
    _close(tlog, jlog, 3e-2, "forward logits")
    _, tcache = TM.prefill(tp, tcfg, tb, max_len=max_len)
    for kk in ("k", "v"):
        _close(tcache["blocks"][0][kk][0], jcache["blocks"][0][kk][0], 3e-2,
               f"layer 0 {kk}")
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    fcfg, fp, fcache = _one_layer_blocks(jcfg, jp, jcache)
    jlog2, _ = jax.jit(functools.partial(JM.decode_step, cfg=fcfg))(
        fp, cache=fcache, tokens=jnp.asarray(tok), pos=jnp.int32(S_TEXT))
    tcache = jax.tree.map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).bfloat16(), jcache)
    tlog2, _ = TM.decode_step(tp, tcfg, tcache, torch.from_numpy(tok),
                              S_TEXT)
    _close(tlog2, jlog2, 3e-2, "decode logits")


def test_bf16_activation_rounding():
    """The bfloat16 rule behind the test above: XLA's CPU backend
    computes ``jax.nn.silu`` as ``x * (1 / (1 + exp(-x)))`` with every
    step rounded to bfloat16, where ``F.silu`` (the port) rounds once.
    The port's stays within one bfloat16 step of the float32 value; the
    two differ on a large share of points, where the port's is the
    closer."""
    x = np.linspace(-8, 8, 4097).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).bfloat16()
    want = np.asarray(jax.jit(jax.nn.silu)(jx), np.float32)
    steps = (tx * (1 / (1 + torch.exp(-tx)))).float().numpy()
    once = torch.nn.functional.silu(tx).float().numpy()
    exact = torch.nn.functional.silu(tx.float()).numpy()
    np.testing.assert_array_equal(steps, want)
    assert (once != want).mean() > 0.1
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exact), 1e-30))) - 7)
    assert (np.abs(once - exact) <= step).all()
    assert np.abs(once - exact).mean() < np.abs(want - exact).mean()


def test_cache_specs_match_reference():
    """The cache layout, with whisper's cross entries of
    ``num_prefix_tokens`` frames and gemma3's period of 2."""
    for arch in ("whisper-base", "gemma3-27b", "kimi-k2-1t-a32b"):
        jcfg, tcfg = _cfgs(arch)
        jspec = JM.cache_specs(jcfg, 3, 40)
        tspec = TM.cache_specs(tcfg, 3, 40)
        for key in ("head", "blocks", "tail"):
            assert len(tspec[key]) == len(jspec[key]), (arch, key)
            for je, te in zip(jspec[key], tspec[key]):
                assert sorted(je) == sorted(te), (arch, key)
                for kk, (shape, dt) in te.items():
                    assert tuple(je[kk].shape) == shape, (arch, kk)
                    assert str(je[kk].dtype) == \
                        str(dt).replace("torch.", "")
    cross = TM.cache_specs(_cfgs("whisper-base")[1], 3, 40)["blocks"][0]
    assert cross["cross_k"][0] == (4, 3, 8, 2, 16)


# ------------------------------------------------------------------ server
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b",
                                  "h2o-danube-1.8b"])
def test_server_tokens_match_reference(arch):
    """3 requests of 20 tokens over 2 slots: the same tokens per
    request as the reference Server on the same weights (laid out one
    layer per block, so that it decodes in depth order), its decode
    handed a copy of the output counts (``_race_free``)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    jsrv = _race_free(JS.Server(*_one_layer_blocks(jcfg, jp), max_len=48,
                                batch_slots=2))
    tsrv = TS.Server(tcfg, tp, max_len=48, batch_slots=2, device="cpu")

    def reqs(mod):
        return [mod.Request(rid=r, max_new=4,
                            prompt=(np.arange(S_TEXT, dtype=np.int32) * 7
                                    + 3 * r) % 256) for r in range(3)]
    jreq, treq = reqs(JS), reqs(TS)
    for a, b in zip(jreq, treq):
        jsrv.submit(a)
        tsrv.submit(b)
    jdone, tdone = jsrv.drain(), tsrv.drain()
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.out for r in treq] == [r.out for r in jreq]
    assert all(len(r.out) == 4 for r in treq)


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-base"])
def test_serve_refuses_frontend_archs(arch):
    """The Server carries tokens only (the reference's raises KeyError
    on these two); the port names the frontend instead, before any
    weights are drawn."""
    with pytest.raises(ValueError, match="stub"):
        serve(arch, device="cpu")
    _, tcfg = _cfgs(arch)
    with pytest.raises(ValueError, match=tcfg.frontend):
        TS.Server(tcfg, {}, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b",
                                  "h2o-danube-1.8b", "jamba-v0.1-52b",
                                  "llama3-405b", "kimi-k2-1t-a32b"])
def test_launch_serve_text_archs(arch):
    """``serve`` runs every text-only architecture reduced on the CPU:
    each request gets its tokens, in the vocabulary, with finite
    logits."""
    rep = serve(arch, requests=3, prompt_len=S_TEXT, max_new=4, slots=2,
                device="cpu")
    assert rep.cfg.name == arch and rep.served == 3
    assert rep.prefills == 3 and rep.init_s > 0
    assert all(0 <= t < 256 for r in rep.requests for t in r.out)
    assert torch.isfinite(rep.server.last_logits).all()
