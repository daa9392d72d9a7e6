"""Parity of the port's one-device training path (``repro_torch.data``,
``repro_torch.optim``, ``models.model.loss_fn`` with remat,
``models.steps.make_train_step``, ``train.trainer``) with the JAX
reference on the CPU, and of the gradients through the two kernels'
``autograd.Function``s (``kernels.moe_route.ops.route_dense``,
``kernels.ssd_scan.ops.ssd_scan``; on the CPU their forwards are the
plain versions).

Tolerances: the synthetic batches bit for bit; ``adamw_update``
elementwise, each output's error relative to the size of its update's
operands (``|old| + |new - old|``, which a cancelling sum keeps) at most
1e-6 in float32, and one bfloat16 step for bfloat16 state (the largest
float32 ulp gap is reported: XLA contracts some products into fused
multiply-adds and sums the squares in its own order); the router's
gradient within 1e-6; the SSD scan's within 1e-4 in float32; every
parameter's gradient of the loss within atol 1e-5 + rtol 1e-3; the
20-step loss list within 1e-5 at step 0 and 1e-3 at every step.
The reference trains through ``lax.scan`` over its superblocks and the
port unrolled, so their float32 sums run in other orders.

Each reference side runs inside the one test that needs it (module
fixtures are rebuilt on every test worker), and JAX's compiled programs
are dropped after every test.
"""
import gc
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JCkpt
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import steps as JS
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import make_train_state as jax_make_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax, train_state_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.kernels.moe_route import ops as route_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import model as TM
from repro_torch.models import steps as TS
from repro_torch.optim import (AdamWConfig, abstract_train_state,
                               adamw_update, make_train_state)
from repro_torch.train.trainer import ResourceBroker, TrainConfig, Trainer
from repro_torch.tree import tree_leaves, walk
from test_torch_serve import _jax_init, _np_tree

torch.set_num_threads(1)     # small tensors; leave the cores to XLA

TINY = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
            head_dim=16, d_ff=64, vocab_size=128)   # test_runtime tiny_cfg
GRAD_ARCHS = ["qwen3-0.6b", "olmoe-1b-7b", "mamba2-780m", "jamba-v0.1-52b",
              "paligemma-3b", "whisper-base"]


@pytest.fixture(autouse=True)
def _release_jax_programs():
    """Drop the test's compiled JAX programs when it ends.  Each holds
    memory mappings; a test worker that gathers more than the kernel's
    ``vm.max_map_count`` (65,530) crashes in a later XLA compile."""
    yield
    jax.clear_caches()
    gc.collect()


def _cfgs(arch):
    over = TINY if arch == "qwen3-0.6b" else {}
    return (jax_get_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def _torch_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,seq,batch,seed", [(128, 32, 4, 0),
                                                  (64, 16, 8, 1),
                                                  (50, 7, 6, 3)])
def test_synthetic_tokens_bit_equal(vocab, seq, batch, seed):
    """The same config, step and shard give the reference's batch."""
    mine = SyntheticTokens(DataConfig(vocab, seq, batch, seed))
    ref = JSyntheticTokens(JDataConfig(vocab, seq, batch, seed))
    for step in (0, 1, 17):
        for shard, n in ((0, 1), (0, 2), (1, 2)):
            a = mine.batch(step, shard=shard, n_shards=n)["tokens"]
            b = ref.batch(step, shard=shard, n_shards=n)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    it = iter(mine)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  ref.batch(0)["tokens"])


# ------------------------------------------------------------------- AdamW
def _adam_inputs(seed):
    """A parameter tree with a stacked leaf (updated row by row), an
    embedding and a norm; gradients large enough to clip."""
    rng = np.random.default_rng(seed)

    def mk(shape, s):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    p = {"blocks": [{"w": mk((3, 40, 50), 0.05)}], "embed": mk((300, 64), 0.02),
         "final_norm": mk((64,), 0.01)}
    g = jax.tree.map(lambda a: mk(a.shape, 0.3), p)
    m = jax.tree.map(lambda a: mk(a.shape, 0.05), p)
    v = jax.tree.map(lambda a: np.abs(mk(a.shape, 0.01)), p)
    return p, g, m, v


def _ulps(a, b):
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return int(np.abs(ai - bi).max())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype, capsys):
    """``adamw_update`` elementwise against the reference's, at steps 1
    (warm-up), 5 (warm-up ends) and 200, with float32 or bfloat16 m and
    v: params, m and v, the global norm and the new step."""
    p, g, m, v = _adam_inputs(0)
    kw = dict(lr=1e-2, warmup_steps=5, state_dtype=state_dtype)
    jopt, opt = JAdamWConfig(**kw), AdamWConfig(**kw)
    jstep = jax.jit(lambda s, gg: jax_adamw_update(s, gg, jopt))
    worst = {}
    for step in (1, 5, 200):
        jst = {"params": jax.tree.map(jnp.asarray, p),
               "m": jax.tree.map(lambda a: jnp.asarray(a, state_dtype), m),
               "v": jax.tree.map(lambda a: jnp.asarray(a, state_dtype), v),
               "step": jnp.asarray(step - 1, jnp.int32)}
        want, want_norm = jstep(jst, jax.tree.map(jnp.asarray, g))
        st = train_state_from_jax(_np_tree(jst), "cpu")
        got, norm = adamw_update(
            st, jax.tree.map(lambda a: torch.from_numpy(a.copy()), g), opt)
        assert got["step"].dtype == torch.int32 and got["step"].dim() == 0
        assert int(got["step"]) == int(want["step"]) == step
        np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
        for key in ("params", "m", "v"):
            a, b, o = (np.concatenate([np.asarray(t, np.float32).ravel()
                                       for t in leaves])
                       for leaves in ([t.float() for t in
                                       _torch_leaves(got[key])],
                                      jax.tree.leaves(want[key]),
                                      jax.tree.leaves(jst[key])))
            worst[(key, step)] = _ulps(a, b)
            if key != "params" and state_dtype == "bfloat16":
                steps_apart = np.abs(
                    a.view(np.int32).astype(np.int64)
                    - b.view(np.int32).astype(np.int64)) >> 16
                assert steps_apart.max() <= 1, (key, step)
            else:
                rel = np.abs(a - b) / (np.abs(o) + np.abs(b - o))
                assert rel.max() <= 1e-6, (key, step, rel.max())
    with capsys.disabled():
        print(f"\nadamw {state_dtype}: largest float32 ulp gap "
              f"{max(worst.values())} ({max(worst, key=worst.get)})")


# ------------------------------------------------------------------ router
def _route_logits(T, E, seed, ties):
    x = np.random.default_rng(seed).standard_normal((T, E)) \
        .astype(np.float32)
    if ties:          # every third token's experts tied in pairs
        x[::3] = np.repeat(x[::3, :(E + 1) // 2], 2, axis=1)[:, :E]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("renorm", [False, True])
def test_route_grad_matches_reference(renorm, ties, dtype):
    """The Function's logits gradient equals ``jax.grad`` through the
    reference's ``_router_topk`` and ``moe_dense``'s scatter and cast,
    under an upstream gradient on the dense weights and one on the
    weights, with tied logits (the lowest index wins, as the forward's
    ``idx``) and without."""
    T, E, k = 12, 16, 4
    x = _route_logits(T, E, 3, ties)
    rng = np.random.default_rng(4)
    up_dense = rng.standard_normal((T, E)).astype(np.float32)
    up_w = rng.standard_normal((T, k)).astype(np.float32)

    def ref(logits):
        w, idx = JL._router_topk(logits, k, renorm)
        dense = jnp.zeros((T, E), jnp.float32) \
            .at[jnp.arange(T)[:, None], idx].set(w).astype(dtype)
        return (jnp.sum(dense.astype(jnp.float32)
                        * jnp.asarray(up_dense, dtype).astype(jnp.float32))
                + jnp.sum(w * up_w))
    want = np.asarray(jax.jit(jax.grad(ref))(jnp.asarray(x)))
    logits = torch.from_numpy(x).requires_grad_(True)
    w, idx, dense = route_ops.route_dense(logits, k, renorm,
                                          getattr(torch, dtype))
    assert idx.grad_fn is None and not idx.requires_grad
    loss = (dense.float() * torch.from_numpy(up_dense).to(dense.dtype)
            .float()).sum() + (w * torch.from_numpy(up_w)).sum()
    loss.backward()
    np.testing.assert_allclose(logits.grad.numpy(), want, rtol=1e-6,
                               atol=1e-6)
    assert np.abs(want).max() > 1e-3          # the gradient is not empty


def test_route_grad_dense_only_matches_reference():
    """The path ``moe_dense`` takes: the weights unused (their gradient
    is None), renormalised, bfloat16 dense weights."""
    T, E, k = 9, 8, 2
    x = _route_logits(T, E, 5, True)
    up = np.random.default_rng(6).standard_normal((T, E)).astype(np.float32)

    def ref(logits):
        w, idx = JL._router_topk(logits, k, True)
        dense = jnp.zeros((T, E), jnp.float32) \
            .at[jnp.arange(T)[:, None], idx].set(w).astype(jnp.bfloat16)
        return jnp.sum(dense.astype(jnp.float32) * up)
    want = np.asarray(jax.jit(jax.grad(ref))(jnp.asarray(x)))
    logits = torch.from_numpy(x).requires_grad_(True)
    _, _, dense = route_ops.route_dense(logits, k, True, torch.bfloat16)
    (dense.float() * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(logits.grad.numpy(), want, rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------- SSD
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 40, 3, 8, 16, 16),
                                             (1, 32, 2, 16, 8, 16)])
def test_ssd_grad_matches_reference(B, S, H, P, N, chunk, with_state):
    """The Function's gradients of x, dt, A, Bm and Cm equal
    ``jax.grad`` of the reference's ``ssd_chunked`` (float32), under an
    upstream gradient on y and, with ``with_state``, on the final state
    (training gives it none: the Function takes a None there)."""
    rng = np.random.default_rng(B * S)
    args = [(rng.standard_normal((B, S, H, P)) * 0.3).astype(np.float32),
            rng.uniform(0.001, 0.1, (B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (H,)).astype(np.float32),
            (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32),
            (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)]
    up_y = rng.standard_normal((B, S, H, P)).astype(np.float32)
    up_s = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def ref(*a):
        y, st = JL.ssd_chunked(*a, chunk)
        out = jnp.sum(y * up_y)
        return out + jnp.sum(st * up_s) if with_state else out
    want = jax.jit(jax.grad(ref, argnums=(0, 1, 2, 3, 4)))(*args)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = ssd_ops.ssd_scan(*ins, chunk)
    loss = (y * torch.from_numpy(up_y)).sum()
    if with_state:
        loss = loss + (st * torch.from_numpy(up_s)).sum()
    loss.backward()
    for name, t, w in zip(("x", "dt", "A", "Bm", "Cm"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# -------------------------------------------------------------------- loss
def _batch(cfg, B=2, S=20, seed=0):
    """Seeded tokens (20: past a reduced chunk of 16 and a window of 16)
    and seeded frontend embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.frontend == "audio_stub":
        batch["encoder_embeds"] = (rng.standard_normal(
            (B, 16, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_grads_match_reference(arch):
    """Every parameter's gradient of the port's ``loss_fn`` equals
    ``jax.grad`` of the reference's ``loss_fn(..., moe_dense)`` (remat
    on, its default), on the reference's own ``init_params``: tiny qwen3
    (``test_runtime.py``'s ``tiny_cfg``), and reduced OLMoE (the
    router), mamba2 (the SSD scan), jamba (both), paligemma (the loss
    past the prefix) and whisper (the encoder).  Remat off, and remat
    with either policy, give the port the same gradients, bit for bit."""
    jcfg, cfg = _cfgs(arch)
    jp = _jax_init(jcfg, 0)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jbatch, JL.moe_dense)))(jp)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = model_params_from_jax(_np_tree(jp), "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    paths = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    first = None
    for remat, policy in ((True, "nothing"), (False, "nothing"),
                          (True, "dots")):
        rcfg = cfg.__class__(**{**cfg.__dict__, "remat": remat,
                                "remat_policy": policy})
        loss = TM.loss_fn(params, rcfg, tbatch)
        grads = torch.autograd.grad(loss, leaves)
        if first is None:
            first = grads
            np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                       rtol=1e-5,
                                       atol=1e-5)
            for path, g, w in zip(paths, grads, jax.tree.leaves(jgrads)):
                assert tuple(g.shape) == w.shape, path
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-3, atol=1e-5,
                                           err_msg=path)
        else:
            for path, g, g0 in zip(paths, grads, first):
                assert torch.equal(g, g0), (remat, policy, path)
    named = [p for p, g in zip(paths, first) if not g.abs().max() > 0]
    assert not named, f"zero gradients: {named}"


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_remat_recomputes_each_superblock_once(arch, monkeypatch):
    """With remat the backward reruns each superblock's forward once: the
    router's and the scan's Functions run twice per layer (every reduced
    layer here is in a superblock), with either policy; without remat,
    once.  An unknown policy is refused."""
    _, cfg = _cfgs(arch)
    assert cfg.plan_blocks()[0] == cfg.plan_blocks()[3] == 0
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    calls = {"route": 0, "scan": 0}

    def counted(name, real):
        def fn(*a):
            calls[name] += 1
            return real(*a)
        return fn
    monkeypatch.setattr(route_ops, "_route",
                        counted("route", route_ops._route))
    monkeypatch.setattr(ssd_ops, "_scan", counted("scan", ssd_ops._scan))
    plan = cfg.layer_plan()
    per_pass = {"route": sum(s.moe for s in plan),
                "scan": sum(s.kind == "ssm" for s in plan)}
    for remat, policy, passes in ((False, "nothing", 1), (True, "nothing", 2),
                                  (True, "dots", 2)):
        calls.update(route=0, scan=0)
        rcfg = cfg.__class__(**{**cfg.__dict__, "remat": remat,
                                "remat_policy": policy})
        torch.autograd.grad(TM.loss_fn(params, rcfg, batch), leaves)
        assert calls == {k: passes * n for k, n in per_pass.items()}, \
            (remat, policy)
    with pytest.raises(ValueError, match="remat_policy"):
        TM.loss_fn(params, cfg.__class__(**{**cfg.__dict__,
                                            "remat_policy": "all"}), batch)


def test_lm_loss_matches_reference():
    """``lm_loss`` in float32 from bfloat16 logits, with and without a
    prefix offset."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 13, 40)).astype(np.float32)
    toks = rng.integers(0, 40, (2, 9)).astype(np.int32)
    for prefix in (0, 4):
        want = JM.lm_loss(jnp.asarray(logits, jnp.bfloat16),
                          jnp.asarray(toks), prefix)
        got = TM.lm_loss(torch.from_numpy(logits).to(torch.bfloat16),
                         torch.from_numpy(toks), prefix)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------- training
def test_train_loss_list_matches_reference():
    """20 steps of ``make_train_step`` on tiny qwen3 (the reference's
    ``test_learns_and_checkpoints`` run: ``DataConfig(128, 32, 4, 0)``,
    ``AdamWConfig(lr=1e-2, warmup_steps=5)``) from the reference's
    ``init_params`` give the reference's losses: step 0 within 1e-5,
    every step within 1e-3, and they fall."""
    jcfg, cfg = _cfgs("qwen3-0.6b")
    data = SyntheticTokens(DataConfig(128, 32, 4, 0))
    kw = dict(lr=1e-2, warmup_steps=5)
    jstate = jax_make_train_state(_jax_init(jcfg, 0), JAdamWConfig(**kw))
    state = train_state_from_jax(_np_tree(jstate), "cpu")
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamWConfig(**kw)))
    step = TS.make_train_step(cfg, AdamWConfig(**kw))
    want, got = [], []
    for i in range(20):
        toks = data.batch(i)["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-2)
    assert abs(got[0] - want[0]) <= 1e-5, (got[0], want[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert got[-1] < got[0]
    assert int(state["step"]) == 20


def _tiny_trainer(tmp_path, steps, broker=None, every=5):
    _, cfg = _cfgs("qwen3-0.6b")
    return Trainer(cfg, DataConfig(128, 32, 4, 0), AdamWConfig(lr=1e-2),
                   TrainConfig(steps=steps, checkpoint_every=every,
                               checkpoint_dir=str(tmp_path)),
                   broker or ResourceBroker(1), device="cpu")


def test_trainer_crash_restart_resumes(tmp_path):
    """As ``test_runtime.py``'s ``test_crash_restart_resumes``: 10 steps,
    then a new trainer resumes from the step-10 checkpoint and runs only
    steps 10..14.  The resumed state equals the saved one, and its
    template holds no storage."""
    rep1 = _tiny_trainer(tmp_path, 10).run(resume=False)
    assert rep1.steps_done == 10 and len(rep1.losses) == 10
    tr = _tiny_trainer(tmp_path, 15)
    rep2 = tr.run(resume=True)
    assert rep2.restores == 1
    assert rep2.steps_done == 15
    assert len(rep2.losses) == 5
    assert int(tr.state["step"]) == 15
    assert all(np.isfinite(rep1.losses + rep2.losses))
    tmpl = abstract_train_state(TM.abstract_params(tr.cfg), tr.opt)
    assert all(t.device.type == "meta" for t in _torch_leaves(tmpl))
    got = _torch_leaves(tr.state)
    assert [(tuple(t.shape), t.dtype) for t in _torch_leaves(tmpl)] == \
        [(tuple(t.shape), t.dtype) for t in got]


def test_async_checkpoint_mid_run_holds_its_step(tmp_path):
    """An asynchronous save in the middle of a run holds the state of its
    own step, though ``adamw_update`` goes on writing the state in place
    while the file is written: the writer here waits until the next step
    has run.  Its file equals, leaf for leaf, the one a blocking run
    writes at that step."""
    tr = _tiny_trainer(tmp_path / "async", 5, every=3)
    assert tr.tcfg.async_checkpoint
    stepped = threading.Event()
    step, save, write = tr._step, tr.ckpt.save, tr.ckpt._write

    def step_then_signal(state, batch):
        out = step(state, batch)
        stepped.set()
        return out

    def save_then_wait(*a, **k):
        stepped.clear()
        save(*a, **k)

    def write_after_next_step(*a):
        assert stepped.wait(60)
        write(*a)
    tr._step = step_then_signal
    tr.ckpt.save = save_then_wait
    tr.ckpt._write = write_after_next_step
    rep = tr.run(resume=False)
    assert rep.steps_done == 5 and tr.ckpt.all_steps() == [3]
    ref = _tiny_trainer(tmp_path / "blocking", 3, every=3)
    ref.tcfg.async_checkpoint = False
    ref.run(resume=False)
    with np.load(tr.ckpt._path(3)) as a, np.load(ref.ckpt._path(3)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(np.load(tr.ckpt._path(3))["['step']"]) == 3


def test_tree_walk_is_jax_order_and_keystr():
    """``tree.walk`` gives a train state's leaves in ``jax.tree.leaves``'
    order, keyed by ``keystr``, and marks stacked exactly the leaves under
    a ``['blocks']`` of params, m or v, each with one row per
    superblock."""
    jcfg, cfg = _cfgs("jamba-v0.1-52b")
    st = make_train_state(TM.abstract_params(cfg), AdamWConfig())
    jst = jax.eval_shape(lambda: jax_make_train_state(
        JM.init_params(jcfg, jax.random.key(0)), JAdamWConfig()))
    want = [(jax.tree_util.keystr(path), leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jst)[0]]
    got = [(k, tuple(t.shape)) for k, _, t in walk(st)]
    assert got == want
    stacked = [(k, t.shape[0]) for k, is_stacked, t in walk(st)
               if is_stacked]
    n_super = cfg.plan_blocks()[2]
    assert stacked == [(k, n_super) for k, _ in want
                       if k.split("]")[1] == "['blocks'"]


def test_resume_across_implementations(tmp_path):
    """The reference's ``Trainer`` writes step 10 (tiny qwen3, 15 steps,
    a checkpoint every 5); the port's ``Trainer`` resumes from that file
    to step 15, and its losses for steps 10..14 are the reference's
    uninterrupted run's within 1e-3."""
    jcfg, _ = _cfgs("qwen3-0.6b")
    ref_dir, dir_ = tmp_path / "ref", tmp_path / "port"
    jrep = JTrainer(jcfg, JDataConfig(128, 32, 4, 0), JAdamWConfig(lr=1e-2),
                    JTrainConfig(steps=15, checkpoint_every=5,
                                 checkpoint_dir=str(ref_dir),
                                 async_checkpoint=False)).run(resume=False)
    dir_.mkdir()
    shutil.copy(ref_dir / "ckpt_00000010.npz", dir_)
    rep = _tiny_trainer(dir_, 15).run(resume=True)
    assert rep.restores == 1 and len(rep.losses) == 5
    np.testing.assert_allclose(rep.losses, jrep.losses[10:], rtol=0,
                               atol=1e-3)


def test_port_checkpoint_restores_in_reference(tmp_path):
    """A float32 train state the port's ``Trainer`` writes restores into
    the reference's template, leaf for leaf."""
    tr = _tiny_trainer(tmp_path, 5)
    tr.run(resume=False)
    jcfg, _ = _cfgs("qwen3-0.6b")
    tmpl = jax.eval_shape(lambda: jax_make_train_state(
        JM.init_params(jcfg, jax.random.key(0)), JAdamWConfig()))
    got = JCkpt(str(tmp_path)).restore(5, tmpl)
    for a, b in zip(jax.tree.leaves(got), _torch_leaves(tr.state)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


def test_make_train_state_layout():
    """The reference's state keys and dtypes: m and v in the state dtype,
    ``step`` a 0-d int32; the step leaves the gradients dropped."""
    _, cfg = _cfgs("qwen3-0.6b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    st = make_train_state(params, AdamWConfig(state_dtype="bfloat16"))
    assert sorted(st) == ["m", "params", "step", "v"]
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    assert all(t.dtype == torch.bfloat16 for t in _torch_leaves(st["m"]))
    step = TS.make_train_step(cfg, AdamWConfig(state_dtype="bfloat16"))
    batch = {"tokens": torch.from_numpy(_batch(cfg)["tokens"])}
    st, m = step(st, batch)
    assert all(p.grad is None and p.is_leaf
               for p in tree_leaves(st["params"]))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_train_profiler_imports_neither_jax_nor_repro():
    """``profile_train.py`` (beside chip_smoke.py and the other
    profilers, which ``test_torch_fleet.py`` scans) imports no ``jax``
    and nothing of ``repro``."""
    import ast
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "profile_train.py"
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                         "repro")]
    assert not bad, bad
