"""Parity of the port's sharded train step (``models.steps`` on DTensors
placed by ``launch.shardings.distribute``: FSDP over "data", TP and EP
over "model", a second dp axis "pod") with the JAX reference's train
step jitted with ``in_shardings`` from ``train_state_specs``, on the
CPU.

The port's ranks are local CPU processes in one gloo group
(``launch.mesh.spawn_local``; the function is
``repro_torch.launch.local.sharded_train_rank``), the reference's a
subprocess with four forced host devices (``conftest.run_with_devices``);
each joins within 120 s.  Both start from the reference's
``init_params(key(0))``, written as its step-0 checkpoint.

Tolerances are the one-device train tests' (``tests/test_torch_train.py``):
the loss within 1e-5 at step 0 and 1e-3 at every step, the grad norm
within rtol 1e-2, every first-step gradient within atol 1e-5 + rtol
1e-3.  The parameters after the last step are held leaf by leaf by
their update: ``|dp_port - dp_ref| <= 1e-3 |dp_ref|`` in the L2 norm.
Elementwise they are not a gradient's tolerance: AdamW's first updates
are ``lr g / (|g| + eps)``, so a gradient element within a few eps of 0
(where the sums' order moves its last bits) moves its parameter by up
to ``lr``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import local
from repro_torch.launch.mesh import spawn_local
from repro_torch.optim import AdamWConfig

torch.set_num_threads(1)

JOIN_S = 120
STEPS = 2
DCFG = (256, 32, 4, 0)
OPT = dict(lr=1e-2, warmup_steps=2)

_REF_STEP = """
import json
import numpy as np, jax, jax.numpy as jnp
from repro.checkpoint.checkpoint import CheckpointManager
from repro.configs import get_config
from repro.data.pipeline import DataConfig, SyntheticTokens
from repro.launch import shardings as sh
from repro.launch.mesh import dp_axes, make_mesh
from repro.models import model as M
from repro.models import steps as S
from repro.optim import AdamWConfig, make_train_state
cfg = get_config({arch!r}).reduced(**{over!r})
opt = AdamWConfig(**{opt!r})
dcfg = DataConfig(*{dcfg!r})
mesh = make_mesh({shape!r}, {axes!r})
mi = M.MeshInfo(mesh, dp_axes(mesh), "model",
                sh.batch_sharded(dcfg.global_batch, mesh))
named = sh.to_named(sh.train_state_specs(cfg, mesh), mesh)
bnamed = sh.to_named(sh.batch_specs(cfg, mesh, dcfg.global_batch), mesh)
state = make_train_state(M.init_params(cfg, jax.random.key(0)), opt)
CheckpointManager({ckpt!r}).save(0, jax.tree.map(np.asarray, state),
                                 blocking=True)
state = jax.device_put(state, named)
p0 = {{"p0" + jax.tree_util.keystr(k): np.asarray(v) for k, v in
      jax.tree_util.tree_leaves_with_path(state["params"])}}
step = jax.jit(S.make_train_step(cfg, opt, mi),
               in_shardings=(named, bnamed), out_shardings=(named, None))
moe_fn = S.make_moe_fn(mi)
grad = jax.jit(jax.grad(lambda p, b: M.loss_fn(p, cfg, b, moe_fn)),
               in_shardings=(named["params"], bnamed))
data = SyntheticTokens(dcfg)
losses, norms = [], []
for i in range({steps}):
    batch = {{k: jnp.asarray(v) for k, v in data.batch(i).items()}}
    if i == 0:
        g0 = {{"g" + jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_leaves_with_path(grad(state["params"],
                                                       batch))}}
    state, m = step(state, batch)
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
params = {{"p" + jax.tree_util.keystr(k): np.asarray(v) for k, v in
          jax.tree_util.tree_leaves_with_path(state["params"])}}
np.savez({out!r}, losses=np.asarray(losses), grad_norms=np.asarray(norms),
         **params, **p0, **g0)
print("REF_OK")
"""

CASES = [
    # FSDP over "data" and TP over "model"
    ("qwen3-0.6b", {}, (2, 2), ("data", "model")),
    # moe_ep over an ep axis of 2, pairs dropped at capacity factor 1.0
    ("olmoe-1b-7b", dict(capacity_factor=1.0), (2, 2), ("data", "model")),
    # the batch cut over two dp axes ("pod", "data"), FSDP over "data"
    ("qwen3-0.6b", {}, (2, 2, 1), ("pod", "data", "model")),
]


@pytest.mark.parametrize("arch,over,shape,axes", CASES,
                         ids=["qwen3_fsdp_tp", "olmoe_ep2", "qwen3_pod"])
def test_sharded_train_step_matches_reference(tmp_path, arch, over, shape,
                                              axes):
    """Two train steps of the port over a 4-rank mesh against the
    reference's jitted step over the same mesh of 4 host devices: the
    losses, the grad norms and the parameters after the last step; and
    on every rank each state and batch leaf's block under
    ``distribute`` (DTensor placements from ``to_placements``; the batch
    over ("pod", "data") on the 3-axis mesh) equals ``local_shard``'s,
    the reference's ``NamedSharding`` layout."""
    from conftest import run_with_devices
    ckpt, ref_out = tmp_path / "ckpt", tmp_path / "ref.npz"
    r = run_with_devices(_REF_STEP.format(
        arch=arch, over=over, opt=OPT, dcfg=DCFG, shape=shape, axes=axes,
        ckpt=str(ckpt), steps=STEPS, out=str(ref_out)), 4, timeout=JOIN_S)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-3000:]
    out = tmp_path / "port"
    out.mkdir()
    cfg = get_config(arch).reduced(**over)
    spawn_local(local.sharded_train_rank, 4, cfg, DataConfig(*DCFG),
                AdamWConfig(**OPT), shape, axes, STEPS, str(ckpt), str(out),
                timeout=JOIN_S)
    ref = np.load(ref_out)
    got = [np.load(out / f"rank{i}.npz") for i in range(4)]
    for g in got:
        assert g["blocks"].size == 0, g["blocks"]   # distribute = local_shard
        np.testing.assert_array_equal(g["losses"], got[0]["losses"])
    losses, norms = got[0]["losses"], got[0]["grad_norms"]
    assert abs(losses[0] - ref["losses"][0]) <= 1e-5, (losses, ref["losses"])
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(norms, ref["grad_norms"], rtol=1e-2)
    for prefix in ("g[", "p["):
        assert sorted(k for k in ref.files if k.startswith(prefix)) == \
            sorted(k for k in got[0].files if k.startswith(prefix))
    for k in (k for k in ref.files if k.startswith("g[")):
        np.testing.assert_allclose(got[0][k], ref[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)
        assert np.abs(ref[k]).max() > 0, k
    for k in (k for k in ref.files if k.startswith("p[")):
        want, p0 = ref[k] - ref["p0" + k[1:]], ref["p0" + k[1:]]
        err = np.linalg.norm(got[0][k] - p0 - want)
        assert err <= 1e-3 * np.linalg.norm(want), (k, err)


SERVE_ARCHS = ("gemma3-27b", "olmoe-1b-7b", "mamba2-780m")


def _plain_decode(cfg, path):
    """The plain steps (one process, whole tensors, ``moe_dense``) on
    ``local.decode_inputs``' inputs under ``path``: the prefill's last
    logits, then each teacher-forced decode step's."""
    from repro_torch.models import model as TM
    params = torch.load(path / "params.pt")
    with np.load(path / "in.npz") as z:
        logits, cache = TM.prefill(params, cfg, {
            "tokens": torch.from_numpy(z["tokens"])},
            max_len=int(z["max_len"]))
        out = [logits]
        for pos, tok in zip(z["pos"].tolist(), z["step_tokens"]):
            logits, cache = TM.decode_step(params, cfg, cache,
                                           torch.from_numpy(tok), pos)
            out.append(logits)
    return torch.cat(out, 1).numpy()


def test_sharded_prefill_decode_match_plain(tmp_path):
    """``make_prefill_step`` and two teacher-forced ``make_decode_step``
    steps over a (2, 2) mesh of 4 gloo ranks on DTensors (the KV cache's
    sequence cut over "model": each rank's partial softmax, merged
    across the ranks; a decode step writes into the block holding its
    position) give the plain steps' logits within 1e-5 on every rank: 4
    prompts of 16 seeded tokens, a 24-deep cache; reduced gemma3
    (windows, a 2-layer period), olmoe (``moe_ep``; no pair dropped at
    the reduced capacity factor, so ``moe_dense``'s function) and mamba2
    (the SSM cache, heads cut over "model")."""
    cases = []
    for arch in SERVE_ARCHS:
        cfg = get_config(arch).reduced()
        (tmp_path / arch).mkdir()
        local.decode_inputs(str(tmp_path / arch), cfg, [16, 17], max_len=24)
        cases.append((arch, cfg, str(tmp_path / arch)))
    out = tmp_path / "out"
    out.mkdir()
    spawn_local(local.sharded_decode_rank, 4, cases, (2, 2),
                ("data", "model"), str(out), timeout=JOIN_S)
    for arch, cfg, path in cases:
        want = _plain_decode(cfg, tmp_path / arch)
        for rank in range(4):
            got = np.load(out / f"rank{rank}.npz")
            np.testing.assert_allclose(got[f"{arch}/logits"], want, rtol=0,
                                       atol=1e-5, err_msg=arch)


_REF_RESIZE = """
import numpy as np, jax
from repro.checkpoint.checkpoint import CheckpointManager
from repro.configs import get_config
from repro.data.pipeline import DataConfig
from repro.models import model as M
from repro.optim import AdamWConfig, make_train_state
from repro.train.trainer import ScheduledBroker, TrainConfig, Trainer
cfg = get_config("olmoe-1b-7b").reduced(capacity_factor=1.0)
opt = AdamWConfig(**{opt!r})
state = jax.tree.map(np.asarray, make_train_state(
    M.init_params(cfg, jax.random.key(0)), opt))
for d in ({ref!r}, {port!r}):
    CheckpointManager(d).save(0, state, blocking=True)
rep = Trainer(cfg, DataConfig(*{dcfg!r}), opt,
              TrainConfig(steps={steps}, checkpoint_every={steps},
                          checkpoint_dir={ref!r}, async_checkpoint=False),
              ScheduledBroker({sched!r}, 1)).run(resume=True)
assert rep.resizes == [({grow}, 1, 2)], rep.resizes
print("REF_OK")
"""


def test_trainer_resize_matches_reference_state(tmp_path):
    """The ``Trainer`` under ``ScheduledBroker({0: 1, 2: 2}, 1)`` on 2
    gloo ranks (reduced OLMoE, capacity factor 1.0), against the
    reference's ``Trainer`` on 2 host devices from the same step-0
    checkpoint: after the resize at step 2 each rank holds its FSDP
    block of the broadcast state and updates it; the train state after
    step 3 gathered whole is the reference's: the step count exactly,
    each parameter by its update and each AdamW moment within 1e-3 of
    the reference's in the L2 norm (the bound above)."""
    from conftest import run_with_devices
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.models import model as M
    from repro_torch.optim import abstract_train_state
    from repro_torch.tree import walk
    steps, grow = 4, 2
    ref_dir, port_dir, out = (tmp_path / d for d in ("ref", "port", "out"))
    r = run_with_devices(_REF_RESIZE.format(
        opt=OPT, dcfg=DCFG, steps=steps, grow=grow, sched={0: 1, grow: 2},
        ref=str(ref_dir), port=str(port_dir)), 2, timeout=JOIN_S)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-3000:]
    out.mkdir()
    cfg = get_config("olmoe-1b-7b").reduced(capacity_factor=1.0)
    opt = AdamWConfig(**OPT)
    spawn_local(local.trainer_rank, 2, cfg, DataConfig(*DCFG), opt,
                {0: 1, grow: 2}, steps, str(port_dir), str(out),
                timeout=JOIN_S)
    got = np.load(out / "rank0.npz")
    assert got["resizes"].tolist() == [[grow, 1, 2]]
    tmpl = abstract_train_state(M.abstract_params(cfg), opt)
    init, want = (CheckpointManager(str(d)).restore(s, tmpl, "cpu")
                  for d, s in ((port_dir, 0), (ref_dir, steps)))
    for (key, _, a), (_, _, b) in zip(walk(init), walk(want)):
        g = got[f"s{key}"]
        if key == "['step']":
            assert int(g) == int(b) == steps
            continue
        delta = (b - a).numpy()
        err = np.linalg.norm(g - a.numpy() - delta)
        assert err <= 1e-3 * np.linalg.norm(delta), (key, err)
