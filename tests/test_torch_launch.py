"""Parity of the port's mesh, placement map, expert-parallel MoE and
elastic trainer (``repro_torch.launch``, ``models.layers.moe_ep``,
``train.trainer``) with the JAX reference on the CPU.

Multi-rank runs: the port's ranks are local CPU processes in one gloo
group (``launch.mesh.spawn_local``; their functions live in
``repro_torch.launch.local``, since a spawned child imports its target's
module and this one imports JAX), the reference's a subprocess with
forced host devices (``conftest.run_with_devices``).  Each joins within
120 s.  Wherever losses are compared, both sides start from one train
state: the reference's, written as a step-0 checkpoint by its
``CheckpointManager``, from which the port's ``Trainer`` resumes.

Tolerances: placement trees and configs equal; ``moe_ep``'s ``buf_tok``
exactly, its output and every gradient within 1e-5 (float32); the
trainers' losses within 1e-5 at step 0 and 1e-3 at every step; the
train state's digests (whole and each rank's block) bit-equal where they
must be.
"""
import dataclasses
import gc
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.checkpoint.checkpoint import CheckpointManager as JCkpt
from repro.configs import LAISSEZCLOUD as J_LAISSEZCLOUD
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable_shapes as j_applicable_shapes
from repro.configs import arch_names as j_arch_names
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.launch import shardings as JSH
from repro.launch.mesh import make_mesh as j_make_mesh
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import make_train_state as jax_make_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import LAISSEZCLOUD, SHAPES, applicable_shapes
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import local
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import MeshShape, make_mesh, spawn_local
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import ResourceBroker, TrainConfig, Trainer
from test_torch_serve import _jax_init, _np_tree

torch.set_num_threads(1)

TINY = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
            head_dim=16, d_ff=64, vocab_size=128)   # test_runtime tiny_cfg
DROP = dict(capacity_factor=1.0)                   # reduced OLMoE that drops
JOIN_S = 120


@pytest.fixture(autouse=True)
def _release_jax_programs():
    """Drop the test's compiled JAX programs when it ends (a test worker
    that gathers too many crashes in a later XLA compile)."""
    yield
    jax.clear_caches()
    gc.collect()


def _cfgs(arch, **over):
    return (jax_get_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


# ------------------------------------------------------------ placements
def _canon(spec):
    """A placement's entries as tuples of axis names (None -> ())."""
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _canon_tree(tree, leaf):
    if isinstance(tree, leaf):
        return _canon(tree)
    if isinstance(tree, dict):
        return {k: _canon_tree(v, leaf) for k, v in tree.items()}
    assert isinstance(tree, list), type(tree)
    return [_canon_tree(v, leaf) for v in tree]


MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data",
                                                         "model")),
          ((4, 1), ("data", "model")), ((2, 2), ("data", "model"))]


@pytest.mark.parametrize("shape,axes", MESHES)
def test_placement_trees_match_reference(shape, axes):
    """``param_specs``, ``train_state_specs``, ``batch_specs``,
    ``cache_specs_tree``, ``logits_spec`` and ``batch_sharded`` equal the
    reference's for all ten configs at every shape's global batch (the
    reference reads only the mesh's ``shape`` and ``axis_names``)."""
    jmesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                  axis_names=axes)
    mesh = MeshShape(shape, axes)
    for name in j_arch_names():
        jcfg, cfg = jax_get_config(name), get_config(name)
        for fn in ("param_specs", "train_state_specs"):
            assert _canon_tree(getattr(SH, fn)(cfg, mesh), SH.P) == \
                _canon_tree(getattr(JSH, fn)(jcfg, jmesh), JP), (name, fn)
        for gb in sorted({s.global_batch for s in J_SHAPES.values()}):
            assert SH.batch_sharded(gb, mesh) == JSH.batch_sharded(gb, jmesh)
            for fn in ("batch_specs", "cache_specs_tree"):
                got = _canon_tree(getattr(SH, fn)(cfg, mesh, gb), SH.P)
                want = _canon_tree(getattr(JSH, fn)(jcfg, jmesh, gb), JP)
                assert got == want, (name, fn, gb)
            assert _canon(SH.logits_spec(cfg, mesh, gb)) == \
                _canon(JSH.logits_spec(jcfg, jmesh, gb)), (name, gb)


def test_local_shard_blocks():
    """``local_shard`` on one rank of a (1, 1) mesh leaves a tensor
    whole; ``replicated_over`` takes axes out of every entry."""
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    t = torch.arange(24.0).reshape(4, 6)
    assert SH.local_shard(t, SH.P("data", "model"), mesh) is t
    spec = {"a": SH.P(("pod", "data"), "model", None), "b": [SH.P()]}
    assert SH.replicated_over(spec, ("data",)) == \
        {"a": (("pod",), "model", None), "b": [()]}


def test_configs_match_reference():
    """``SHAPES``, ``applicable_shapes`` of every config, the MoE fields
    (and ``reduced()``'s capacity factor) and ``LAISSEZCLOUD`` equal the
    reference's."""
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    for name in j_arch_names():
        jcfg, cfg = jax_get_config(name), get_config(name)
        assert applicable_shapes(cfg) == j_applicable_shapes(jcfg), name
        for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
            for f in ("capacity_factor", "moe_psum_dtype", "moe_combine"):
                assert getattr(c, f) == getattr(j, f), (name, f)
    assert dataclasses.asdict(LAISSEZCLOUD) == \
        dataclasses.asdict(J_LAISSEZCLOUD)


# ------------------------------------------------------------------ moe_ep
def _moe_inputs(cfg, B=4, S=32, seed=0):
    """The reference's reduced layer-0 MoE leaves (``init_params``) and
    seeded x and upstream gradient, as numpy."""
    jp = _jax_init(cfg, seed)
    moe = {k: np.asarray(v[0]) for k, v in jp["blocks"][0]["moe"].items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    up = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return moe, x, up


def _ref_dispatch(jcfg, xf, router, cap, lo, El):
    """The reference ``moe_ep``'s ``buf_tok`` and per-expert counts for
    one rank's tokens (the lines of its ``inner``, which keeps them)."""
    E, k = jcfg.num_experts, jcfg.num_experts_per_tok
    T = xf.shape[0]
    w, idx = JL._router_topk(jnp.asarray(xf) @ jnp.asarray(router), k,
                             jcfg.moe_renormalize)
    eid = idx.reshape(-1)
    order = jnp.argsort(eid)
    sorted_eid = eid[order]
    counts = jnp.zeros((E,), jnp.int32).at[eid].add(1)
    offsets = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k) - offsets[sorted_eid]
    local = (sorted_eid >= lo) & (sorted_eid < lo + El) & (rank < cap)
    slot = jnp.where(local, (sorted_eid - lo) * cap + rank, El * cap)
    buf_tok = jnp.full((El * cap + 1,), T, jnp.int32) \
        .at[slot].set(order // k, mode="drop")[:El * cap]
    return np.asarray(buf_tok), np.asarray(counts)


def _ref_moe_ep(jcfg, mesh, moe, x, up):
    def loss(p, xx):
        y = JL.moe_ep(p, jcfg, xx, mesh=mesh, dp_axes=("data",),
                      ep_axis="model", batch_sharded=True)
        return jnp.sum(y * up), y
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in moe.items()}, jnp.asarray(x))
    return np.asarray(y), np.asarray(gx), {k: np.asarray(v)
                                           for k, v in gp.items()}


def test_moe_ep_one_rank_matches_reference():
    """``moe_ep`` on a (1, 1) mesh (one rank: the trainer's one-device
    path) against the reference's on ``make_mesh((1, 1))``, reduced
    OLMoE with capacity factor 1.0: ``buf_tok`` exactly, pairs dropped,
    the output and the gradients of x, the router and the three expert
    leaves within 1e-5."""
    jcfg, cfg = _cfgs("olmoe-1b-7b", **DROP)
    moe, x, up = _moe_inputs(jcfg)
    y_ref, gx_ref, gp_ref = _ref_moe_ep(
        jcfg, j_make_mesh((1, 1), ("data", "model")), moe, x, up)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in moe.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    L.DISPATCH = []
    try:
        y = L.moe_ep(p, cfg, tx, mesh=mesh, ep_axis="model")
        (buf_tok, counts, cap, _, _), = L.DISPATCH
    finally:
        L.DISPATCH = None
    (y * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), gx_ref, rtol=0, atol=1e-5)
    for k in moe:
        np.testing.assert_allclose(p[k].grad.numpy(), gp_ref[k], rtol=0,
                                   atol=1e-5, err_msg=k)
        assert np.abs(gp_ref[k]).max() > 0, k
    T, E = x.shape[0] * x.shape[1], cfg.num_experts
    xf = x.reshape(T, -1)
    want_buf, want_counts = _ref_dispatch(jcfg, xf, moe["router"], cap, 0, E)
    np.testing.assert_array_equal(buf_tok.numpy(), want_buf)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert cap == 32 and int((counts - cap).clamp(min=0).sum()) > 0


def test_prefill_decode_steps_over_mesh_match_reference():
    """``make_prefill_step`` and ``make_decode_step`` over a (1, 1) mesh
    (the MoE layers run ``moe_ep``; reduced OLMoE, capacity factor 1.0)
    against the reference's step factories on ``make_mesh((1, 1))``: a
    4 x 32-token prefill's last logits and K/V cache, then one decode
    step from the reference's cache, within 1e-4."""
    from repro.models import steps as JS
    from repro_torch.convert import model_params_from_jax
    from repro_torch.models import steps as TS
    jcfg, cfg = _cfgs("olmoe-1b-7b", **DROP)
    jp = _jax_init(jcfg, 0)
    tp = model_params_from_jax(_np_tree(jp), "cpu")
    toks = np.random.default_rng(0).integers(0, 256, (4, 32)).astype(np.int32)
    max_len = 40
    jmi = JM.MeshInfo(j_make_mesh((1, 1), ("data", "model")), ("data",),
                      "model", True)
    mi = TM.MeshInfo(make_mesh((1, 1), ("data", "model"), "cpu"), ("data",),
                     "model")
    jlog, jcache = jax.jit(JS.make_prefill_step(jcfg, max_len, jmi,
                                                scan_layers=False))(
        jp, {"tokens": jnp.asarray(toks)})
    tlog, tcache = TS.make_prefill_step(cfg, max_len, mi)(
        tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-4)
    for kk in ("k", "v"):
        np.testing.assert_allclose(tcache["blocks"][0][kk].numpy(),
                                   np.asarray(jcache["blocks"][0][kk]),
                                   rtol=0, atol=1e-4, err_msg=kk)
    tcache = {key: [{kk: torch.from_numpy(np.array(v)) for kk, v in e.items()}
                    for e in jcache[key]] for key in jcache}
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    jlog2, _ = jax.jit(JS.make_decode_step(jcfg, jmi))(
        jp, jcache, jnp.asarray(tok), jnp.int32(32))
    tlog2, _ = TS.make_decode_step(cfg, mi)(tp, tcache,
                                            torch.from_numpy(tok), 32)
    np.testing.assert_allclose(tlog2.numpy(), np.asarray(jlog2), rtol=0,
                               atol=1e-4)


_REF_MOE_EP_2x2 = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import layers as L
cfg = get_config("olmoe-1b-7b").reduced(capacity_factor=1.0,
                                        moe_combine={combine!r})
z = np.load({inp!r})
moe = {{k: jnp.asarray(z[k]) for k in ("router", "wg", "wu", "wd")}}
mesh = make_mesh((2, 2), ("data", "model"))
def loss(p, x):
    y = L.moe_ep(p, cfg, x, mesh=mesh, dp_axes=("data",), ep_axis="model",
                 batch_sharded=True)
    return jnp.sum(y * z["up"]), y
(_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True))(moe, z["x"])
np.savez({out!r}, y=np.asarray(y), gx=np.asarray(gx),
         **{{"g_" + k: np.asarray(v) for k, v in gp.items()}})
print("REF_OK")
"""


@pytest.mark.parametrize("combine", ["allreduce", "scatter_gather"])
def test_moe_ep_2x2_mesh_matches_reference(tmp_path, combine):
    """``moe_ep`` on 4 gloo ranks of a (2, 2) mesh against the
    reference's on 4 host devices, reduced OLMoE with capacity factor
    1.0 (16 tokens a batch block, 32 slots an expert): each rank's
    ``buf_tok`` and counts exactly (the reference's lines on its block
    and experts), the output and x's gradient block by block, the router's
    and each rank's experts' gradients summed over "data", within 1e-5.
    ``scatter_gather`` rounds the combined output to bfloat16: there the
    output and the gradients that follow it are held to one bfloat16
    step of it."""
    from conftest import run_with_devices
    jcfg, cfg = _cfgs("olmoe-1b-7b", moe_combine=combine, **DROP)
    moe, x, up = _moe_inputs(jcfg, B=4, S=16)
    inp, ref_out = tmp_path / "in.npz", tmp_path / "ref.npz"
    np.savez(tmp_path / "in.tmp.npz", x=x, up=up, **moe)
    os.replace(tmp_path / "in.tmp.npz", inp)
    r = run_with_devices(_REF_MOE_EP_2x2.format(
        combine=combine, inp=str(inp), out=str(ref_out)), 4, timeout=JOIN_S)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-2000:]
    out_dir = tmp_path / "port"
    out_dir.mkdir()
    spawn_local(local.moe_ep_rank, 4, cfg, (2, 2), str(inp), str(out_dir),
                timeout=JOIN_S)
    ref = np.load(ref_out)
    tol = 1e-5 if combine == "allreduce" else 1e-2
    E = cfg.num_experts
    El, Bl = E // 2, x.shape[0] // 2
    drops = 0
    for rank in range(4):
        got = np.load(out_dir / f"rank{rank}.npz")
        d, j = got["coord"]
        blk = slice(d * Bl, (d + 1) * Bl)
        ex = slice(j * El, (j + 1) * El)
        np.testing.assert_allclose(got["y"], ref["y"][blk], rtol=0, atol=tol)
        np.testing.assert_allclose(got["gx"], ref["gx"][blk], rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(got["g_router"], ref["g_router"], rtol=0,
                                   atol=tol)
        for k in ("wg", "wu", "wd"):
            np.testing.assert_allclose(got[f"g_{k}"], ref[f"g_{k}"][ex],
                                       rtol=0, atol=tol, err_msg=k)
        xf = x[blk].reshape(-1, cfg.d_model)
        cap = L.moe_capacity(cfg, xf.shape[0])
        want_buf, want_counts = _ref_dispatch(jcfg, xf, moe["router"], cap,
                                              j * El, El)
        np.testing.assert_array_equal(got["buf_tok"], want_buf)
        np.testing.assert_array_equal(got["counts"], want_counts)
        drops += int(np.maximum(got["counts"][ex] - cap, 0).sum())
    assert cap == 8 and drops > 0


# ---------------------------------------------------------------- trainers
def _write_ref_init(jcfg, opt_kw, directory):
    """The reference's initial train state (``init_params(key(0))``,
    zero AdamW state) as its step-0 checkpoint in ``directory``."""
    state = jax_make_train_state(_jax_init(jcfg, 0), JAdamWConfig(**opt_kw))
    JCkpt(str(directory)).save(0, jax.tree.map(np.asarray, state),
                               blocking=True)


def test_trainer_runs_capacity_limited_moe(tmp_path):
    """The fault of the one-device port: the reference's ``Trainer``
    always builds a mesh, so it trains ``moe_ep`` (reduced OLMoE,
    capacity factor 1.0: pairs dropped).  The port's ``Trainer``, resumed
    from the reference's step-0 checkpoint, gives its losses: step 0
    within 1e-5, every step within 1e-3.  ``moe_dense`` (the parent's
    path) misses the reference's step-0 loss by more than 1e-5."""
    jcfg, cfg = _cfgs("olmoe-1b-7b", **DROP)
    opt_kw = dict(lr=1e-2, warmup_steps=2)
    dcfg = (256, 32, 4, 0)
    steps = 6
    _write_ref_init(jcfg, opt_kw, tmp_path / "port")
    jrep = JTrainer(jcfg, JDataConfig(*dcfg), JAdamWConfig(**opt_kw),
                    JTrainConfig(steps=steps, checkpoint_every=100,
                                 checkpoint_dir=str(tmp_path / "ref"),
                                 async_checkpoint=False)).run(resume=False)
    tr = Trainer(cfg, DataConfig(*dcfg), AdamWConfig(**opt_kw),
                 TrainConfig(steps=steps, checkpoint_every=100,
                             checkpoint_dir=str(tmp_path / "port")),
                 ResourceBroker(1), device="cpu")
    first = {k: torch.from_numpy(v) for k, v in
             tr.data.batch(0).items()}
    state0 = tr.ckpt.restore(0, tr._template(), "cpu")
    rep = tr.run(resume=True)
    assert rep.restores == 1 and rep.resizes == []
    assert abs(rep.losses[0] - jrep.losses[0]) <= 1e-5, \
        (rep.losses[0], jrep.losses[0])
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=0, atol=1e-3)
    dense = float(TM.loss_fn(state0["params"], cfg, first))
    assert abs(dense - jrep.losses[0]) > 1e-5, (dense, jrep.losses[0])


_REF_ELASTIC = """
import json
from repro.configs import get_config
from repro.data.pipeline import DataConfig
from repro.optim import AdamWConfig
from repro.train.trainer import Trainer, TrainConfig, ScheduledBroker
cfg = get_config("olmoe-1b-7b").reduced(capacity_factor=1.0)
rep = Trainer(cfg, DataConfig(256, 32, 4, 0),
              AdamWConfig(lr=1e-2, warmup_steps=2),
              TrainConfig(steps=16, checkpoint_every=8,
                          checkpoint_dir={ckpt!r}, async_checkpoint=False),
              ScheduledBroker({{0: 1, 8: 2}}, 1)).run(resume=False)
print("REF " + json.dumps({{"losses": rep.losses,
                           "resizes": rep.resizes}}))
"""


def _ref_json(r):
    assert r.returncode == 0, r.stderr[-2000:]
    line = next(s for s in r.stdout.splitlines() if s.startswith("REF "))
    return json.loads(line[4:])


def test_elastic_resize_matches_reference(tmp_path):
    """``ScheduledBroker({0: 1, 8: 2}, 1)`` on 2 gloo ranks, reduced
    OLMoE with capacity factor 1.0 (so the capacity follows the local
    batch: 32 slots an expert on one rank, 16 on two): both ranks report
    ``resizes == [(8, 1, 2)]`` and the losses of the reference's elastic
    run on 2 host devices within 1e-3 (step 0 within 1e-5); rank 1 sits
    out steps 0-7.  The state is FSDP-sharded over "data": at the resize
    each rank receives rank 0's whole state after step 7 (its digest)
    and keeps its ``NamedSharding`` block of it; after each step each
    rank's blocks are that block of the state gathered whole, the two
    ranks' blocks differ after each of steps 8-15 and the gathered
    states are bit-equal.  (The state after a resize is held to the
    reference's in ``tests/test_torch_sharded.py``.)"""
    from conftest import run_with_devices
    jcfg, cfg = _cfgs("olmoe-1b-7b", **DROP)
    opt_kw = dict(lr=1e-2, warmup_steps=2)
    r = run_with_devices(_REF_ELASTIC.format(ckpt=str(tmp_path / "ref")), 2,
                         timeout=JOIN_S)
    ref = _ref_json(r)
    assert ref["resizes"] == [[8, 1, 2]]
    _write_ref_init(jcfg, opt_kw, tmp_path / "port")
    out = tmp_path / "out"
    out.mkdir()
    spawn_local(local.trainer_rank, 2, cfg, DataConfig(256, 32, 4, 0),
                AdamWConfig(**opt_kw), {0: 1, 8: 2}, 16,
                str(tmp_path / "port"), str(out), timeout=JOIN_S)
    got = [np.load(out / f"rank{r}.npz") for r in range(2)]
    for g in got:
        assert g["resizes"].tolist() == [[8, 1, 2]]
        assert int(g["restores"]) == 1
        np.testing.assert_array_equal(g["losses"], got[0]["losses"])
    losses = got[0]["losses"]
    assert abs(losses[0] - ref["losses"][0]) <= 1e-5
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=1e-3)
    assert got[0]["digest_steps"].tolist() == list(range(16))
    assert got[1]["digest_steps"].tolist() == list(range(8, 16))
    np.testing.assert_array_equal(got[0]["digests"][8:], got[1]["digests"])
    for g in got:
        np.testing.assert_array_equal(g["local_digests"], g["shard_digests"])
        np.testing.assert_array_equal(g["resize_in"], got[0]["digests"][7:8])
        np.testing.assert_array_equal(g["resize_blocks"], g["resize_shards"])
    assert (got[0]["local_digests"][8:] != got[1]["local_digests"]).all()


_REF_MARKET = """
import json
from repro.configs import get_config
from repro.core.market import Market
from repro.core.topology import build_cluster
from repro.data.pipeline import DataConfig
from repro.optim import AdamWConfig
from repro.train.trainer import Trainer, TrainConfig, MarketBroker
topo = build_cluster({{"H100": 2}}, gpus_per_host=2, hosts_per_rack=1,
                     racks_per_zone=1)
market = Market(topo)
root = topo.roots["H100"]
market.set_floor(root, 2.0)
for _ in range(2):
    market.place_order("trainA", root, 3.0, limit=3.5)
cfg = get_config("qwen3-0.6b").reduced(**{tiny!r})
dcfg = DataConfig(vocab_size=128, seq_len=32, global_batch=4, seed=0)
tc = TrainConfig(steps=8, checkpoint_every=8, checkpoint_dir={ckpt!r})
tr = Trainer(cfg, dcfg, AdamWConfig(lr=1e-2, warmup_steps=4), tc,
             MarketBroker(market, "trainA", max_devices=2))
reps = [tr.run(resume=False)]
market.advance_to(100.0)
market.place_order("rival", root, 4.0, limit=9.0)
tc.steps = 16
reps.append(tr.run(resume=True))
market.advance_to(200.0)
for leaf in list(market.owned_leaves("rival")):
    market.relinquish("rival", leaf)
market.place_order("trainA", root, 3.0, limit=3.5)
tc.steps = 24
reps.append(tr.run(resume=True))
print("REF " + json.dumps({{"losses": [r.losses for r in reps],
                           "bill": market.settle(300.0)["trainA"]}}))
"""


def test_market_driven_elastic_training_matches_reference(tmp_path):
    """``tests/test_system.py``'s scenario (two tenants, two leaves: 8
    steps on 2, a rival outbids to 16 on 1, it leaves and trainA re-bids
    to 24 on 2) through ``launch.train.market_scenario`` on 2 gloo ranks:
    its assertions (8 / 16 / 24 steps done, a restore per resume, the
    loss falls, trainA billed) and the reference's losses on 2 host
    devices within 1e-3."""
    from conftest import run_with_devices
    jcfg, cfg = _cfgs("qwen3-0.6b", **TINY)
    opt_kw = dict(lr=1e-2, warmup_steps=4)
    ref = _ref_json(run_with_devices(_REF_MARKET.format(
        tiny=TINY, ckpt=str(tmp_path / "ref")), 2, timeout=JOIN_S))
    _write_ref_init(jcfg, opt_kw, tmp_path / "port")
    out = tmp_path / "out"
    out.mkdir()
    spawn_local(local.market_rank, 2, cfg, DataConfig(128, 32, 4, 0),
                AdamWConfig(**opt_kw), str(tmp_path / "port"), str(out),
                timeout=JOIN_S)
    for rank in range(2):
        got = np.load(out / f"rank{rank}.npz")
        assert [int(got[f"steps{i}"]) for i in range(3)] == [8, 16, 24]
        assert [int(got[f"restores{i}"]) for i in range(3)] == [1, 1, 1]
        assert all(got[f"resizes{i}"].size == 0 for i in range(3))
        losses = [got[f"losses{i}"] for i in range(3)]
        assert losses[2][-1] < losses[0][0]
        assert float(got["bill"]) > 0.0
        np.testing.assert_allclose(float(got["bill"]), ref["bill"],
                                   rtol=1e-9)
        for i in range(3):
            np.testing.assert_allclose(losses[i], ref["losses"][i], rtol=0,
                                       atol=1e-3)
