"""Model assembly of the port, twin of ``repro.models.model``: parameter
init (its storage-free template, and each rank's own blocks for a model
too large for one card), the unrolled forward (with the
vision prefix, the audio encoder and, for training, each superblock
rematerialised), the loss, prefill, one decode step, and the cache
layout.  Every MoE layer runs ``moe_fn`` (``layers.moe_dense`` by
default, as serving runs it; a train step over a mesh passes
``layers.moe_ep``, see ``models/steps.py``).

Parameters are plain dicts of tensors in the reference's layout::

    params = {
      "embed": (V, D), ["lm_head": (D, V)], "final_norm": (D,),
      "head":   [per-layer dicts]            # leading irregular layers
      "blocks": [j in 0..period) dicts of tensors stacked on a leading
                 n_super axis]
      "tail":   [per-layer dicts]            # partial trailing period
      ["enc_blocks": [the encoder's layers stacked], "enc_final_norm"]
    }

so ``convert.model_params_from_jax`` carries the reference's
``init_params`` tree across unchanged.  Caches use the same
head/blocks/tail layout: K/V for an attention layer (and the encoder's
cross-attention K/V for an encoder-decoder), the conv window and the
float32 SSM state for an SSD layer.  The layers run unrolled (the
reference's ``scan_layers=False``); decode updates the cache in place.
A stacked leaf is cut into its superblock rows with ``unbind``, whose
backward writes the rows' gradients into one stacked gradient (a
``select`` per row would add a zero tensor of the whole stack per row).
"""
from __future__ import annotations

import functools
import math
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.device import DeviceLike, recip32, resolve_device
from repro_torch.launch.shardings import distribute
from repro_torch.models import layers as L

Params = Dict[str, Any]
MoeFn = Callable[..., torch.Tensor]


@dataclass(frozen=True)
class MeshInfo:
    """How a step is distributed. None => single-device path.  The
    reference's ``batch_sharded`` is left out: the batch's placement
    says it."""
    mesh: Any                     # a torch DeviceMesh
    dp_axes: Tuple[str, ...]
    ep_axis: str


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _stack(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {k: (_stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
                else torch.stack([t[k] for t in trees]))
            for k in trees[0]}


def _unstack(tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A stacked tree's rows (views along the first axis), one tree per
    row."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(subs.values())))
        return [{k: subs[k][s] for k in subs} for s in range(n)]
    return tree.unbind(0)


# --------------------------------------------------------------------------
# Parameter init (the reference's shapes, scales and dtypes)
# --------------------------------------------------------------------------
class _Dense:
    """A random matrix not drawn yet: the layer builders return these,
    and ``draw`` makes each one when its place is ready, so that at most
    one float32 draw exists beside the parameters."""

    def __init__(self, ini: "_Init", shape, dtype, scale):
        self.ini, self.shape, self.dtype, self.scale = ini, shape, dtype, \
            scale

    def draw(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Draw on the generator's device in float32 and scale in place;
        return it as a new tensor of the parameter dtype on the target
        device, or write it into ``out`` (a row of a stacked leaf)."""
        if self.ini.device.type == "meta":   # a template: no storage
            return torch.empty(self.shape, dtype=self.dtype,
                               device="meta") if out is None else out
        gen = self.ini.gen
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=gen.device).mul_(self.scale)
        if out is None:
            return x.to(device=self.ini.device, dtype=self.dtype)
        return out.copy_(x)


class _Init:
    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen = gen
        self.device = device

    def norm(self, d):
        return torch.zeros((d,), dtype=torch.float32, device=self.device)

    def dense(self, shape, dtype, scale=None) -> _Dense:
        fan_in = shape[-2] if len(shape) >= 2 else shape[0]
        scale = scale if scale is not None else fan_in ** -0.5
        return _Dense(self, tuple(shape), dtype, scale)


def _materialize(tree):
    """Draw every ``_Dense`` leaf of a layer tree, in the tree's order."""
    if isinstance(tree, dict):
        return {k: _materialize(v) for k, v in tree.items()}
    return tree.draw() if isinstance(tree, _Dense) else tree


def _empty_stack(tree, n: int, device: torch.device):
    """Uninitialised stacked leaves (leading axis ``n``) for a layer
    tree's shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n, device) for k, v in tree.items()}
    return torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype,
                       device=device)


def _fill_row(stack, tree, s: int) -> None:
    """Write one layer tree into row ``s`` of its stacked leaves."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _fill_row(stack[k], v, s)
        elif isinstance(v, _Dense):
            v.draw(out=stack[k][s])
        else:
            stack[k][s].copy_(v)


def _stacked(build, n: int, device: torch.device):
    """``n`` layers from ``build(s)`` stacked on a leading axis, each
    leaf drawn straight into its row: the stack is allocated once and no
    layer is ever held beside it."""
    first = build(0)
    stack = _empty_stack(first, n, device)
    _fill_row(stack, first, 0)
    for s in range(1, n):
        _fill_row(stack, build(s), s)
    return stack


def _attn_params(cfg: ArchConfig, ini: _Init, dt):
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": ini.dense((D, H * hd), dt),
        "wk": ini.dense((D, K * hd), dt),
        "wv": ini.dense((D, K * hd), dt),
        "wo": ini.dense((H * hd, D), dt,
                        scale=(H * hd) ** -0.5 / (2 * cfg.num_layers) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = ini.norm(hd)
        p["k_norm"] = ini.norm(hd)
    return p


def _mlp_params(cfg: ArchConfig, ini: _Init, dt, ff):
    D = cfg.d_model
    out_scale = ff ** -0.5 / (2 * cfg.num_layers) ** 0.5
    if cfg.mlp_type == "swiglu":
        return {"wg": ini.dense((D, ff), dt),
                "wu": ini.dense((D, ff), dt),
                "wd": ini.dense((ff, D), dt, scale=out_scale)}
    return {"wi": ini.dense((D, ff), dt),
            "wo_mlp": ini.dense((ff, D), dt, scale=out_scale)}


def _moe_params(cfg: ArchConfig, ini: _Init, dt):
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {"router": ini.dense((D, E), torch.float32),
            "wg": ini.dense((E, D, F), dt),
            "wu": ini.dense((E, D, F), dt),
            "wd": ini.dense((E, F, D), dt,
                            scale=F ** -0.5 / (2 * cfg.num_layers) ** 0.5)}


def _linspace32(start: float, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace`` in float32 as XLA computes it under jit:
    ``start * (1 - t) + stop * t`` with ``t = iota * float32(1 / (num -
    1))`` (a division by a constant becomes a product with its float32
    reciprocal), and the last point exactly ``stop``."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32)
    t = torch.arange(num - 1, dtype=torch.float32) * recip32(num - 1)
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32)])


def _ssm_params(cfg: ArchConfig, ini: _Init, dt):
    """The reference's SSD block parameters.  The deterministic leaves
    are built as the reference builds them (``A_log`` is log of its
    float32 linspace; XLA's float32 log differs from torch's in the last
    bit on a few points, one of the 48 at full width), the random ones
    drawn from ``ini``'s generator with the reference's distributions
    and scales."""
    D, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * N
    dev = ini.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((H,), generator=ini.gen, dtype=torch.float32,
                   device=ini.gen.device) * (hi - lo) + lo
    return {
        "in_proj": ini.dense((D, 2 * din + 2 * N + H), dt),
        "conv_w": ini.dense((cfg.ssm_conv, conv_ch), torch.float32, 0.2),
        "conv_b": torch.zeros((conv_ch,), dtype=torch.float32, device=dev),
        "A_log": torch.log(_linspace32(1.0, 16.0, H)).to(dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))).to(dev),
        "ssm_norm": ini.norm(din),
        "out_proj": ini.dense((din, D), dt,
                              scale=din ** -0.5 / (2 * cfg.num_layers) ** 0.5),
    }


def _layer_params(cfg: ArchConfig, spec: LayerSpec, ini: _Init, dt,
                  cross: bool = False):
    """One layer's tree (random matrices not drawn yet): the mixer, the
    decoder's cross-attention when ``cross``, then the MoE or the dense
    MLP."""
    p: Dict[str, Any] = {"ln1": ini.norm(cfg.d_model)}
    if spec.kind == "attn":
        p["attn"] = _attn_params(cfg, ini, dt)
    else:
        p["ssm"] = _ssm_params(cfg, ini, dt)
    if cross:
        p["ln_x"] = ini.norm(cfg.d_model)
        p["cross"] = _attn_params(cfg, ini, dt)
    if spec.moe:
        p["ln2"] = ini.norm(cfg.d_model)
        p["moe"] = _moe_params(cfg, ini, dt)
    elif cfg.d_ff:
        p["ln2"] = ini.norm(cfg.d_model)
        p["mlp"] = _mlp_params(cfg, ini, dt, cfg.d_ff)
    return p


def init_params(cfg: ArchConfig, gen: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random parameters with the reference's shapes, scales and dtypes,
    drawn from ``gen`` (on ``gen``'s device, then moved to ``device``).
    The numbers differ from the reference's ``jax.random`` draws; tests
    carry the reference's own parameters across instead.

    Every matrix is drawn in float32 and cast into its place, and a
    stacked leaf is allocated once and filled row by row, so the peak is
    the parameters plus one float32 draw (at full width the largest is
    the embedding's)."""
    dev = resolve_device(device)
    ini = _Init(gen, dev)
    dt = _dtype(cfg)
    plan = cfg.layer_plan()
    head, p, n_super, tail = cfg.plan_blocks()

    def layer(i):
        return _materialize(_layer_params(cfg, plan[i], ini, dt,
                                          cross=cfg.enc_dec))

    def stacked(j):
        return _stacked(lambda s: _layer_params(
            cfg, plan[head + s * p + j], ini, dt, cross=cfg.enc_dec),
            n_super, dev)
    params: Params = {"embed": ini.dense((cfg.vocab_size, cfg.d_model), dt,
                                         0.02).draw(),
                      "final_norm": ini.norm(cfg.d_model)}
    params["head"] = [layer(i) for i in range(head)]
    params["blocks"] = [stacked(j) for j in range(p)] if n_super else []
    params["tail"] = [layer(head + n_super * p + t) for t in range(tail)]
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.dense((cfg.d_model, cfg.vocab_size), dt,
                                      0.02).draw()
    if cfg.enc_dec:
        eplan = cfg.encoder_plan()
        params["enc_blocks"] = [_stacked(
            lambda s: _layer_params(cfg, eplan[s], ini, dt), len(eplan),
            dev)] if eplan else []
        params["enc_final_norm"] = ini.norm(cfg.d_model)
    return params


def init_blocks(cfg: ArchConfig, specs, mesh, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random parameters as DTensors placed by ``specs`` (a
    ``launch.shardings.param_specs`` tree) on ``mesh``, for a model whose
    whole ``init_params`` does not fit one card: ``abstract_params``
    placed by ``shardings.distribute``, whose ``fill`` makes each rank's
    block of each leaf.  A random matrix's block is drawn from a
    ``torch.Generator`` seeded by ``seed``, the leaf's path and the
    block's global offset (so a block held by several ranks is the same
    on each), with the init's distribution and scale; the small
    deterministic leaves (norms, the SSM's ``A_log``, ``D``,
    ``dt_bias``) are built whole from a per-layer seed and cut.  The
    values depend on the mesh's cuts, not on the rank that draws them.
    Collective-free."""
    if cfg.enc_dec:
        raise ValueError(f"{cfg.name}: init_blocks has no encoder")
    dev = resolve_device(device)
    dt = _dtype(cfg)
    plan = cfg.layer_plan()
    head, p, n_super, _ = cfg.plan_blocks()
    emb = _Init(torch.Generator(dev).manual_seed(seed), dev)
    top = {"embed": emb.dense((cfg.vocab_size, cfg.d_model), dt, 0.02),
           "final_norm": emb.norm(cfg.d_model),
           "lm_head": emb.dense((cfg.d_model, cfg.vocab_size), dt, 0.02)}

    @functools.lru_cache(maxsize=None)
    def layer(i):
        """Layer ``i``'s tree, its random matrices not drawn."""
        return _layer_params(cfg, plan[i], _Init(torch.Generator(
            dev).manual_seed(seed * 100_003 + i), dev), dt)

    def block(leaf, path, shape, offset):
        """The block of ``leaf`` (a ``_Dense`` or a whole tensor) at
        ``offset`` of shape ``shape``."""
        if isinstance(leaf, _Dense):
            gen = torch.Generator(dev).manual_seed(
                zlib.crc32(f"{seed}/{path}/{offset}".encode()))
            return torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=dev).mul_(leaf.scale).to(leaf.dtype)
        return leaf[tuple(slice(o, o + n) for o, n in zip(offset, shape))]

    def fill(path, shape, offset):
        if path[0] in top:
            return block(top[path[0]], path, shape, offset)
        group, j, *keys = path

        def leaf(i):
            return functools.reduce(lambda t, k: t[k], keys, layer(i))
        if group != "blocks":
            i = j if group == "head" else head + n_super * p + j
            return block(leaf(i), path, shape, offset)
        # A stacked leaf: row ``s`` is layer ``head + s * p + j``.
        rows = range(offset[0], offset[0] + shape[0])
        out = torch.empty(shape, dtype=leaf(head + j).dtype, device=dev)
        for r, s in enumerate(rows):
            out[r] = block(leaf(head + s * p + j), path + (s,), shape[1:],
                           offset[1:])
        return out
    return distribute(abstract_params(cfg), specs, mesh, fill=fill)


def abstract_params(cfg: ArchConfig) -> Params:
    """``init_params``' tree with shapes and dtypes but no storage (every
    leaf on the ``meta`` device; nothing is drawn)."""
    return init_params(cfg, torch.Generator(), "meta")


# --------------------------------------------------------------------------
# One layer, the stack, the encoder, forward
# --------------------------------------------------------------------------
def _ffn(p, cfg: ArchConfig, spec: LayerSpec, x, moe_fn: MoeFn):
    """The layer's MoE or dense MLP on the normed residual, or None."""
    if spec.moe:
        return moe_fn(p["moe"], cfg, L.rms_norm(x, p["ln2"]))
    if cfg.d_ff:
        return L.mlp(p["mlp"], cfg, L.rms_norm(x, p["ln2"]))
    return None


def _apply_layer(p, cfg: ArchConfig, spec: LayerSpec, x, positions, *,
                 moe_fn: MoeFn, prefix_len: int = 0,
                 enc_out: Optional[torch.Tensor] = None,
                 causal: bool = True, collect: bool = False,
                 max_len: int = 0):
    """Returns (x, cache_entry|None)."""
    entry = None
    h = L.rms_norm(x, p["ln1"])
    if spec.kind == "attn":
        out, (k, v) = L.attention(p["attn"], cfg, h, positions,
                                  window=spec.window, prefix_len=prefix_len,
                                  causal=causal, return_kv=True)
        if collect:
            pad = max(0, max_len - k.shape[1])
            entry = {"k": L.pad_seq(k, pad), "v": L.pad_seq(v, pad)}
    else:
        out, (conv_tail, ssm_state) = L.ssd_block(p["ssm"], cfg, h)
        if collect:
            entry = {"conv": conv_tail, "ssm": ssm_state}
    x = x + L.pin_batch(out)
    if enc_out is not None and "cross" in p:
        K, hd = cfg.num_kv_heads, cfg.head_dim
        ckv = (L.split_heads(enc_out @ p["cross"]["wk"], K, hd),
               L.split_heads(enc_out @ p["cross"]["wv"], K, hd))
        h = L.rms_norm(x, p["ln_x"])
        x = x + L.pin_batch(L.attention(p["cross"], cfg, h, positions,
                                        kv_override=ckv, causal=False))
        if collect:
            entry["cross_k"], entry["cross_v"] = ckv
    f = _ffn(p, cfg, spec, x, moe_fn)
    if f is not None:
        x = x + L.pin_batch(f)
    return x, entry


def _period_specs(cfg: ArchConfig):
    plan = cfg.layer_plan()
    head, p, n_super, tail = cfg.plan_blocks()
    return plan, head, p, n_super, tail


def _save_products(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of the products without
    batch dimensions (``aten.mm``; ``x @ W`` on a (B, S, D) x folds to
    one), as ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
    does, and recompute everything else."""
    if op == torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ArchConfig):
    """``fn, *args -> fn(*args)`` under ``torch.utils.checkpoint``, as
    the reference's ``jax.checkpoint(body, policy=...)``: nothing saved
    (``remat_policy="nothing"``) or the products' outputs (``"dots"``)."""
    if cfg.remat_policy == "nothing":
        context_fn = ckpt.noop_context_fn
    elif cfg.remat_policy == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_products)
    else:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: expected "
                         "'nothing' or 'dots'")
    return functools.partial(ckpt.checkpoint, use_reentrant=False,
                             context_fn=context_fn)


def _run_stack(params, cfg, x, positions, *, prefix_len, moe_fn, enc_out,
               collect, max_len, remat=False):
    """Head + unrolled superblocks + tail.  With ``remat`` each
    superblock runs under ``torch.utils.checkpoint`` (its activations
    are recomputed in the backward); the head and tail layers do not.
    On DTensors over a mesh with no "model" cut each layer runs on every
    rank's batch block with its parameters gathered whole
    (``layers.dp_blocks``: FSDP a layer at a time, their gradients
    reduce-scattered in the backward); with a "model" cut, under
    DTensor's propagation.  Returns (x, caches dict with head/blocks/tail
    lists)."""
    plan, head, p, n_super, tail = _period_specs(cfg)
    caches: Dict[str, Any] = {"head": [], "blocks": [], "tail": []}

    def layer(lp, spec, xx, pos, eo):
        return _apply_layer(lp, cfg, spec, xx, pos, moe_fn=moe_fn,
                            prefix_len=prefix_len, enc_out=eo,
                            collect=collect, max_len=max_len)

    def one(lp, spec, xx):
        if L.data_parallel(xx):         # every rank's whole layer, locally
            xx, e = L.dp_blocks(lambda pp, xl, eo: layer(
                pp, spec, xl, positions[:1], eo), lp, xx, enc_out)
        else:
            xx, e = layer(lp, spec, xx, positions, enc_out)
        return L.pin_batch(xx), e

    def superblock(xx, s, rows):
        entries = []
        for j in range(p):
            xx, e = one(rows[j][s], plan[head + s * p + j], xx)
            entries.append(e)
        return xx, entries

    for i in range(head):
        x, e = one(params["head"][i], plan[i], x)
        caches["head"].append(e)
    rows = [_unstack(params["blocks"][j]) for j in range(p)] \
        if n_super else []
    run = _remat(cfg) if remat else (lambda fn, *a: fn(*a))
    collected: List[List[Any]] = [[] for _ in range(p)]
    for s in range(n_super):
        x, entries = run(superblock, x, s, rows)
        for j, e in enumerate(entries):
            collected[j].append(e)
    if collect and n_super:
        caches["blocks"] = [_stack(c) for c in collected]
    for t in range(tail):
        i = head + n_super * p + t
        x, e = one(params["tail"][t], plan[i], x)
        caches["tail"].append(e)
    return x, caches


def _encoder_forward(params, cfg: ArchConfig, enc_embeds: torch.Tensor,
                     moe_fn: MoeFn):
    """The audio encoder: bidirectional layers over the frame
    embeddings, then its final norm."""
    x = enc_embeds.to(_dtype(cfg))
    B, S, _ = x.shape
    eplan = cfg.encoder_plan()
    if not eplan:
        return x
    positions = torch.arange(S, device=x.device).expand(B, S)
    rows = _unstack(params["enc_blocks"][0])
    for spec, lp in zip(eplan, rows):
        x, _ = _apply_layer(lp, cfg, spec, x, positions, moe_fn=moe_fn,
                            causal=False)
    return L.rms_norm(x, params["enc_final_norm"])


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` (on DTensors
    ``layers.embed_blocks``: DTensor has no rule for indexing by a
    tensor)."""
    if isinstance(params["embed"], DTensor):
        return L.embed_blocks(params["embed"], tokens)
    return params["embed"][tokens.long()]


def _summed(x: torch.Tensor) -> torch.Tensor:
    """A lookup's pending sum over the ranks that cut the looked-up dim,
    taken now (a DTensor's partial placements made replicated; plain
    tensors as they are).  DTensor keeps a lookup's pending sum with a
    mask of the lookup's shape, good for one reduction of that shape."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def _logits(params, cfg, x):
    x = L.rms_norm(x, params["final_norm"])
    head_w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head_w


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, moe_fn: MoeFn = L.moe_dense, remat: bool = False,
            collect_cache: bool = False, max_len: int = 0):
    """Logits (B, S_total, V) and, with ``collect_cache``, the caches;
    ``remat`` rematerialises each superblock (``_run_stack``).
    ``batch`` holds ``tokens`` (B, S) and, for a frontend architecture,
    ``prefix_embeds`` (B, P, D; vision: prepended, attended both ways)
    or ``encoder_embeds`` (B, frames, D; audio: the encoder's input)."""
    dt = _dtype(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.pin_batch(_embed(params, tokens).to(dt))
    prefix_len = 0
    enc_out = None
    if cfg.frontend == "vision_stub":
        pe = batch["prefix_embeds"].to(dt)
        x = torch.cat([pe, x], dim=1)
        prefix_len = pe.shape[1]
    elif cfg.frontend == "audio_stub":
        enc_out = _encoder_forward(params, cfg, batch["encoder_embeds"],
                                   moe_fn)
    St = x.shape[1]
    positions = torch.arange(St, device=x.device).expand(B, St)
    x, caches = _run_stack(params, cfg, x, positions, prefix_len=prefix_len,
                           moe_fn=moe_fn, enc_out=enc_out,
                           collect=collect_cache,
                           max_len=max_len, remat=remat)
    return _logits(params, cfg, x), (caches if collect_cache else None)


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------
def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            prefix_len: int = 0) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 over the text positions
    (the logits of a vision prefix are skipped)."""
    preds = logits[:, prefix_len:prefix_len + tokens.shape[1] - 1, :].float()
    labels = tokens[:, 1:].long()
    logz = torch.logsumexp(preds, dim=-1)
    gold = _summed(torch.gather(preds, -1, labels[..., None]))[..., 0]
    return torch.mean(logz - gold)


def loss_fn(params: Params, cfg: ArchConfig, batch,
            moe_fn: MoeFn = L.moe_dense) -> torch.Tensor:
    """The training loss, remat as ``cfg.remat`` says."""
    logits, _ = forward(params, cfg, batch, moe_fn=moe_fn, remat=cfg.remat)
    prefix = cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0
    return lm_loss(logits, batch["tokens"], prefix)


# --------------------------------------------------------------------------
# Serving: prefill + decode
# --------------------------------------------------------------------------
def prefill(params: Params, cfg: ArchConfig, batch, *, max_len: int,
            moe_fn: MoeFn = L.moe_dense):
    logits, cache = forward(params, cfg, batch, moe_fn=moe_fn,
                            collect_cache=True, max_len=max_len)
    return logits[:, -1:, :], cache


def decode_step(params: Params, cfg: ArchConfig, cache, tokens: torch.Tensor,
                pos: int, *, moe_fn: MoeFn = L.moe_dense):
    """One decode step.  tokens: (B, 1); pos: host int, the index where
    the new token's KV is written; attends to cache[<= pos] (an SSD layer
    reads only its conv window and state; a decoder's cross-attention
    reads all of the encoder's K/V).  The cache is updated in place and
    returned.

    The layers run in depth order, as ``forward`` runs them.  The
    reference's ``decode_step`` loops over the period position outside
    the superblock, which is depth order only when the period or the
    superblock count is 1; with both above 1 (gemma3-27b: 6 x 10) it
    applies the layers out of order and disagrees with its own forward
    (ROADMAP Queue 3)."""
    x = L.pin_batch(_embed(params, tokens).to(_dtype(cfg)))
    plan, head, p, n_super, tail = _period_specs(cfg)

    def dec_layer(lp, spec, xx, entry):
        h = L.rms_norm(xx, lp["ln1"])
        if spec.kind == "attn":
            out, _, _ = L.attention_decode(lp["attn"], cfg, h, entry["k"],
                                           entry["v"], pos,
                                           window=spec.window)
        else:
            out, conv, ssm = L.ssd_decode(lp["ssm"], cfg, h, entry["conv"],
                                          entry["ssm"])
            entry["conv"].copy_(conv)
            entry["ssm"].copy_(ssm)
        xx = xx + L.pin_batch(out)
        if "cross_k" in entry:
            ckv = (entry["cross_k"], entry["cross_v"])
            out, _, _ = L.attention_decode(lp["cross"], cfg,
                                           L.rms_norm(xx, lp["ln_x"]),
                                           *ckv, pos, cross_kv=ckv)
            xx = xx + L.pin_batch(out)
        f = _ffn(lp, cfg, spec, xx, moe_fn)
        return xx if f is None else xx + L.pin_batch(f)

    for i in range(head):
        x = dec_layer(params["head"][i], plan[i], x, cache["head"][i])
    rows = [(_unstack(params["blocks"][j]), _unstack(cache["blocks"][j]))
            for j in range(p)] if n_super else []
    for s in range(n_super):        # depth order: superblock, then j
        for j in range(p):
            x = dec_layer(rows[j][0][s], plan[head + s * p + j], x,
                          rows[j][1][s])
    for t in range(tail):
        i = head + n_super * p + t
        x = dec_layer(params["tail"][t], plan[i], x, cache["tail"][t])
    return _logits(params, cfg, x), cache


def cache_specs(cfg: ArchConfig, batch: int,
                max_len: int) -> Dict[str, List[Dict[str, Tuple]]]:
    """The cache layout (head/blocks/tail) as ``(shape, dtype)`` pairs;
    an encoder-decoder's entries also hold the cross-attention K/V of
    ``num_prefix_tokens`` frames."""
    dt = _dtype(cfg)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    plan, head, p, n_super, tail = _period_specs(cfg)

    def entry(spec: LayerSpec, lead: Tuple[int, ...] = ()):
        if spec.kind == "attn":
            shape = lead + (batch, max_len, K, hd)
            e = {"k": (shape, dt), "v": (shape, dt)}
        else:
            conv_ch = cfg.d_inner + 2 * cfg.ssm_state
            e = {"conv": (lead + (batch, cfg.ssm_conv - 1, conv_ch), dt),
                 "ssm": (lead + (batch, cfg.ssm_heads, cfg.ssm_headdim,
                                 cfg.ssm_state), torch.float32)}
        if cfg.enc_dec:
            cross = lead + (batch, cfg.num_prefix_tokens, K, hd)
            e["cross_k"] = (cross, dt)
            e["cross_v"] = (cross, dt)
        return e

    return {"head": [entry(plan[i]) for i in range(head)],
            "blocks": [entry(plan[head + j], (n_super,))
                       for j in range(p)] if n_super else [],
            "tail": [entry(plan[head + n_super * p + t])
                     for t in range(tail)]}
