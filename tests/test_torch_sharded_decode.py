"""The decode attention's cross-rank merge, on the CPU: the port's plain
partial (``decode_attention_partial_ref``) and ``merge_partials`` against
the reference's ``decode_attention_ref`` on the whole cache, and decode
steps over a (2, 2) mesh of 4 gloo ranks whose KV cache has its sequence
cut over "model" (``cache_specs_tree``) against the reference's jitted
``make_decode_step`` on 4 host devices with the same shardings.

On a mesh each rank takes the partial softmax of its block of the cache
(the plain partial here, the kernel's partial mode on a card), the
ranks all-gather their ``(o, m, l)`` and merge them
(``kernels/decode_attention/ops.py``).  The blocks are cut so that some
hold every valid position, some a part and some none, and one case has
no valid position at all (the reference's uniform softmax).

Tolerances: 1e-6 in float32 for the merge (the same float32 terms summed
in another order: the blocks' maxima, then their weights); 3e-2 in
bfloat16, the decode kernel's tolerance against its plain version
(tests/test_torch_decode_attention.py: one rounding to bfloat16 of
float32 sums that differ in the last bits).  The sharded decode steps'
logits within 1e-5 of the reference's (float32), the prefill's within
1e-4, the whole-model tolerance of tests/test_torch_models.py.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels.decode_attention import ref as R
from repro_torch.launch import local
from repro_torch.launch.mesh import spawn_local
from torch_serve_check import flipped_tokens, serve_check_rank

torch.set_num_threads(1)

JOIN_S = 120
S, B, K, G, HD = 64, 2, 2, 3, 16
# (pos, window): global, a window inside one block, a window across
# blocks, the last position, no valid position at all
MASKS = [(20, 0), (40, 6), (33, 24), (63, 0), (-1, 0)]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, K, G, HD), (B, S, K, HD), (B, S, K, HD)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R_", [1, 2, 4, 8])
def test_merge_partials_matches_reference(R_, dtype):
    """``merge_partials`` of R blocks' plain partials equals the
    reference's ``decode_attention_ref`` on the whole cache for every
    mask of ``MASKS``; where a block holds no valid position its ``m`` is
    ``NEG_INF`` and its ``l`` its length, and with no valid position
    anywhere the result is the uniform softmax."""
    q, k, v = _inputs(R_)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    n = S // R_
    tol = 1e-6 if dtype == "float32" else 3e-2
    kinds = set()
    for pos, window in MASKS:
        want = np.asarray(jax_decode_ref(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.int32(pos),
            window=window).astype(jnp.float32))
        parts = [R.decode_attention_partial_ref(
            tq, tk[:, r * n:(r + 1) * n], tv[:, r * n:(r + 1) * n], pos,
            window, r * n) for r in range(R_)]
        for r, (_, m, l) in enumerate(parts):
            t = np.arange(r * n, (r + 1) * n)
            valid = (t <= pos) & ((t > pos - window) if window else True)
            kinds.add("full" if valid.all() else "part" if valid.any()
                      else "none")
            if not valid.any():
                assert (m == R.NEG_INF).all() and (l == n).all()
        o, m, l = (torch.stack(x) for x in zip(*parts))
        got = R.merge_partials(o, m, l, dtype=tdt)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol, err_msg=f"{pos} {window}")
    if R_ >= 4:
        assert kinds == {"full", "part", "none"}


_REF_DECODE = """
import dataclasses, pickle
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import ArchConfig
from repro.launch import shardings as sh
from repro.launch.mesh import dp_axes, make_mesh
from repro.models import model as M
from repro.models import steps as S


@dataclasses.dataclass(frozen=True)
class OneLayerBlocks(ArchConfig):
    def plan_blocks(self):
        return 0, self.num_layers, 1, 0


def layers(tree, cfg):
    head, p, n_super, tail = cfg.plan_blocks()
    out = list(tree["head"])
    for s in range(n_super):
        for j in range(p):
            out.append(jax.tree.map(lambda a: a[s], tree["blocks"][j]))
    return out + list(tree["tail"])


def flat(tree, cfg):
    return dict(tree, head=[], tail=[], blocks=[
        jax.tree.map(lambda a: a[None], ly) for ly in layers(tree, cfg)])


cfg = get_config({arch!r}).reduced()
fcfg = OneLayerBlocks(**{{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)}})
mesh = make_mesh({shape!r}, {axes!r})
B, T, max_len = {batch}, {prompt}, {max_len}
mi = M.MeshInfo(mesh, dp_axes(mesh), "model", sh.batch_sharded(B, mesh))
params = M.init_params(cfg, jax.random.key(0))
toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                         (B, T)).astype(np.int32)
named = lambda t: sh.to_named(t, mesh)
bspec = sh.batch_specs(cfg, mesh, B)
prefill = jax.jit(S.make_prefill_step(cfg, max_len, mi),
                  in_shardings=(named(sh.param_specs(cfg, mesh)),
                                named(bspec)))
logits, cache = prefill(params, {{"tokens": jnp.asarray(toks)}})
out = [np.asarray(logits)]
fpn, fcn = (named(sh.param_specs(fcfg, mesh)),
            named(sh.cache_specs_tree(fcfg, mesh, B)))
fp = jax.device_put(flat(params, cfg), fpn)
fc = flat(cache, cfg)
decode = jax.jit(S.make_decode_step(fcfg, mi), in_shardings=(
    fpn, fcn, named(bspec["tokens"]), NamedSharding(mesh, P())))
fed = []
for pos in {positions!r}:
    tok = np.asarray(jnp.argmax(out[-1][:, -1], -1), np.int32)[:, None]
    fed.append(tok)
    logits, fc = decode(fp, jax.device_put(fc, fcn), jnp.asarray(tok),
                        jnp.int32(pos))
    out.append(np.asarray(logits))
with open({params_out!r}, "wb") as f:
    pickle.dump(jax.tree.map(np.asarray, params), f)
np.savez({out!r}, logits=np.concatenate(out, 1), tokens=toks,
         step_tokens=np.stack(fed), pos=np.asarray({positions!r}),
         max_len=max_len)
print("REF_OK")
"""

# arch, batch: B 4 cuts the batch over "data" and the sequence over
# "model" (blocks of 16); the positions: rank 0's block fully valid and
# rank 1's partly (16, 17), then rank 0's partly and rank 1's fully
# masked (8)
DECODE_CASES = [("jamba-v0.1-52b", 4), ("gemma3-27b", 4)]


@pytest.mark.parametrize("arch,batch", DECODE_CASES,
                         ids=["jamba", "gemma3"])
def test_sharded_decode_matches_reference(tmp_path, arch, batch):
    """A prefill of 16 seeded tokens into a 32-deep cache and three
    decode steps over a (2, 2) mesh of 4 gloo ranks (the cache's
    sequence cut over "model": each rank's plain partial, the
    all-gather, ``merge_partials``), teacher-forced with the reference's
    tokens, against the reference's jitted ``make_prefill_step`` and
    ``make_decode_step`` over 4 host devices with ``cache_specs_tree``'s
    shardings, from the reference's ``init_params(key(0))``.  Reduced
    jamba has one attention layer of four (a superblock of one), so the
    reference decodes in depth order; gemma3's decode runs in the
    reference's ``_one_layer_blocks`` layout, as the model tests run
    it."""
    from conftest import run_with_devices
    shape, axes, prompt, max_len = (2, 2), ("data", "model"), 16, 32
    positions = [16, 17, 8]
    ref_out, ref_params = tmp_path / "in.npz", tmp_path / "params.pkl"
    r = run_with_devices(_REF_DECODE.format(
        arch=arch, shape=shape, axes=axes, batch=batch, prompt=prompt,
        max_len=max_len, positions=positions, params_out=str(ref_params),
        out=str(ref_out)), 4, timeout=JOIN_S)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-3000:]
    with open(ref_params, "rb") as f:
        params = model_params_from_jax(pickle.load(f), "cpu")
    torch.save(params, tmp_path / "params.pt")
    out = tmp_path / "port"
    out.mkdir()
    spawn_local(local.sharded_decode_rank, 4,
                [(arch, get_config(arch).reduced(), str(tmp_path))], shape,
                axes, str(out), timeout=JOIN_S)
    want = np.load(ref_out)["logits"]
    for rank in range(4):
        got = np.load(out / f"rank{rank}.npz")
        logits = got[f"{arch}/logits"]
        np.testing.assert_allclose(logits[:, :1], want[:, :1], rtol=0,
                                   atol=1e-4, err_msg="prefill")
        np.testing.assert_allclose(logits[:, 1:], want[:, 1:], rtol=0,
                                   atol=1e-5, err_msg="decode")
        assert int(got[f"{arch}/launches"]) == 0  # the CPU: no kernel


def test_full_width_rank_function_on_cpu_ranks(tmp_path):
    """``torch_serve_check.serve_check_rank``, the four-card run's rank
    function (``launch.local.serve_full`` and the check against the
    plain partial route), on reduced jamba over a (1, 4) mesh of 4 gloo
    ranks: each rank draws only its own parameter blocks
    (``init_blocks``), yet every rank gives the same logits (the
    replicated leaves agree); the cache's sequence is cut in 4 blocks of
    16, the 4 greedy steps fall
    in rank 0's block and the extra one (position 42) in rank 2's; the
    reruns of the first two steps from the caches they read equal the
    run, by both routes (on the CPU both are the plain partial), and so
    does every attention call's output, and no token's routing differs
    between them; ``moe_ep``'s pairs add up to every token's k pairs at
    the prefill and each step."""
    batch, prompt, steps = 4, 16, 4
    spawn_local(serve_check_rank, 4, "jamba-v0.1-52b", (1, 4),
                ("data", "model"), str(tmp_path), batch, prompt, 64, steps,
                2, 0, "cpu", True, timeout=JOIN_S)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    r0 = ranks[0]
    assert r0["logits"].shape == (batch, steps + 2, 256)
    assert int(r0["extra_pos"]) == 42
    cfg = get_config("jamba-v0.1-52b").reduced()
    moe = sum(s.moe for s in cfg.layer_plan())
    k = cfg.num_experts_per_tok
    assert sum(int(g["pairs"]) for g in ranks) == \
        moe * k * batch * (prompt + steps + 1)
    attn = sum(s.kind == "attn" for s in cfg.layer_plan())
    for g in ranks:
        np.testing.assert_array_equal(g["logits"], r0["logits"])
        np.testing.assert_array_equal(g["check_kernel"],
                                      g["logits"][:, 1:3])
        np.testing.assert_array_equal(g["check_plain"], g["check_kernel"])
        assert g["attn_err"].tolist() == [0.0] * 2 * attn
        assert g["flipped"].shape == (2, batch) and not g["flipped"].any()
        assert (g["attn_scale"] > 0).all()
        assert int(g["launches_decode_decode_attention"]) == 0


def test_flipped_tokens_names_the_rows_whose_routing_differs():
    """``torch_serve_check.flipped_tokens``, which picks the rows the
    four-card check holds: two experts of capacity 2 over 4 tokens
    (``4`` marks an empty slot).  Slots reordered flag nothing; token 1
    moved from expert 0 to expert 1, pushing token 3 out of expert 1's
    two slots, flags tokens 1 and 3; token 3 dropped in one routing only
    flags token 3."""
    def route(*slots):
        return [(torch.tensor(slots), 2, 2)]
    same = route(0, 1, 2, 3)
    assert not flipped_tokens(same, route(1, 0, 3, 2), 4).any()
    assert flipped_tokens(route(0, 1, 2, 3), route(0, 4, 1, 2), 4) \
        .tolist() == [False, True, False, True]
    assert flipped_tokens(route(0, 1, 2, 4), route(0, 1, 2, 3), 4) \
        .tolist() == [False, False, False, True]
