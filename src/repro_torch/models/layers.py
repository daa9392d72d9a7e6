"""Layer library of the port, twin of ``repro.models.layers``: attention
(GQA / MQA, sliding window, prefix-LM, cross-attention), the dense MLP,
the MoE layers (``moe_dense``, every expert for every token, which
serving runs; ``moe_ep``, the expert-parallel capacity-limited one,
which a train step over a mesh runs) and the Mamba2 (SSD) block.

Functions keep the reference's names, arguments and layouts.  Four of
them reach the port's kernels: ``attention_decode`` calls
``kernels.decode_attention.ops.decode_attention`` for its attention
core (self- and cross-attention alike), ``moe_dense`` takes its top-k
and its dense combine weights from ``kernels.moe_route.ops.route_dense``
(one launch), ``moe_ep`` its top-k from the same launch, and
``ssd_block`` calls ``kernels.ssd_scan.ops.ssd_scan``
(the CUDA kernels on CUDA tensors, their plain versions on CPU tensors).
Those two are ``autograd.Function``s, so training reaches the router
and every SSM input leaf through the kernels as well (the router's
closed-form backward; the scan's backward through its plain version).
Prefill attention, the projections, the MLPs, the causal conv and the
one-token SSM recurrence (``ssd_decode``, pure jnp in the reference)
stay plain PyTorch, as the reference left them to XLA.

On DTensors (a step over a mesh) the projections and norms run under
DTensor's sharding propagation, and the rest on each rank's blocks
(``local_map`` or ``dp_blocks``): ``moe_ep`` with the reference's
``shard_map`` specs, ``ssd_block`` / ``ssd_decode`` data-parallel only
(as the placement map keeps the SSM; the scan kernel sees this rank's
block), the attention core (``_attend_blocks``) and the vocab-cut
embedding (``embed_blocks``); ``pin_batch`` places the residual stream
as the reference's sharding constraint does.  A decode step writes its
new K/V into the block of the rank that holds ``pos`` (``_put``) before
the attention core reads the cache; where the cache's sequence is cut,
each rank's partial softmax of its block is merged across the ranks
(``kernels/decode_attention/ops.py``).

JAX promotes mixed float types at a product (``bf16 @ f32`` is an f32
product); PyTorch raises instead, so the casts JAX applies silently are
written out here (the router's logits, ``moe_dense``'s combine weights,
``rms_norm``'s f32 compute, the SSM blocks' float32 terms).
``jax.nn.gelu`` is the tanh approximation by default, and
``torch.nn.functional.gelu`` the exact erf form: ``mlp`` asks for the
tanh form.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.device import scatter_drop
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.moe_route import ops as route_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.tree import tree_map

NEG_INF = -2.0 ** 30  # large-negative for masking (safe in bf16)


# --------------------------------------------------------------------------
# Running on each rank's blocks (DTensor inputs)
# --------------------------------------------------------------------------
def _batch_placements(mesh, batch: int):
    """(batch, replicated-parameter gradient) placements per mesh dim:
    the batch cut over the dp axes (every axis but "model") where they
    divide it, else replicated (the reference's ``batch_sharded``; an
    axis of one rank replicates, as ``to_placements`` has it); a
    replicated parameter's gradient is then a partial sum over those
    axes."""
    names = mesh.mesh_dim_names
    dp = [i for i, a in enumerate(names) if a != "model"]
    cut = batch % math.prod(mesh.size(i) for i in dp) == 0
    bpl = tuple(Shard(0) if cut and i in dp and mesh.size(i) > 1
                else Replicate() for i in range(len(names)))
    gpl = tuple(Partial() if p == Shard(0) else p for p in bpl)
    return bpl, gpl


def pin_batch(x: torch.Tensor) -> torch.Tensor:
    """The residual stream (B, S, D) placed as the batch cut over the dp
    axes where they divide it and every other dim whole: the reference's
    ``make_shard_act`` sharding constraint, which the port also puts on
    each sublayer's output before the residual add.  Without them
    DTensor's propagation may carry the stream cut over "model" too (and
    every attention then starts with an all-to-all), or carry a
    row-parallel product's pending sum over "model" into the stream and
    the next norm, and then compute the next products whole on every
    "model" rank: its cost model weighs communication only.  The
    gradient is placed so too (the backward's pending sums are taken
    there).  Plain tensors as they are."""
    if not isinstance(x, DTensor):
        return x
    return _Place.apply(x, _batch_placements(x.device_mesh, x.shape[0])[0])


class _Place(torch.autograd.Function):
    """Identity on values; the value and its gradient redistributed to
    ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def data_parallel(x) -> bool:
    """``x`` is a DTensor on a mesh with no "model" cut (data-parallel
    only: each layer can run whole on each rank's batch block)."""
    if not isinstance(x, DTensor):
        return False
    names = x.device_mesh.mesh_dim_names
    return "model" not in names or \
        x.device_mesh.size(names.index("model")) == 1


def dp_blocks(fn, params, *xs):
    """``fn(params, *xs)`` on each rank's batch block with every parameter
    whole: data-parallel only.  ``params`` is a tree of DTensors, each
    gathered whole (its gradient a partial sum over the dp axes, which
    the gather's backward reduce-scatters onto its placement); each of
    ``xs`` is a DTensor with the batch first (placed as
    ``_batch_placements`` says) or anything else, passed as it is; every
    tensor ``fn`` returns has the batch first.  What ``local_map`` does,
    for any tree of outputs."""
    x0 = next(x for x in xs if isinstance(x, DTensor))
    mesh = x0.device_mesh
    bpl, gpl = _batch_placements(mesh, x0.shape[0])
    rep = (Replicate(),) * mesh.ndim

    def local(t, place, grad):
        return t.redistribute(mesh, place).to_local(grad_placements=grad)
    lp = tree_map(lambda t: local(t, rep, gpl), params)
    lx = [local(x, bpl, bpl) if isinstance(x, DTensor) else x for x in xs]
    return pytree.tree_map(
        lambda t: DTensor.from_local(t, mesh, bpl, run_check=False)
        if isinstance(t, torch.Tensor) else t, fn(lp, *lx))


def embed_blocks(table: DTensor, tokens: DTensor) -> DTensor:
    """``table[tokens]`` on each rank's blocks: the rank looks up the
    table rows it holds (zeros for the others), and the rows are summed
    over the mesh dims that cut the vocabulary (an all-reduce whose
    backward is the identity: every rank then runs the same
    downstream).  DTensor's own rule for a vocab-cut ``F.embedding``
    keeps the sum pending with a mask that its backward cannot take from
    a partial gradient."""
    mesh = table.device_mesh
    bpl, gpl = _batch_placements(mesh, tokens.shape[0])
    cuts = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    shape, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    tgrad = tuple(table.placements[i] if i in cuts else g
                  for i, g in enumerate(gpl))

    def local(block, ids):
        if not cuts:                    # the plain lookup
            return block[ids.long()]
        ids = ids.long() - offset[0]
        held = (ids >= 0) & (ids < shape[0])
        rows = block[torch.where(held, ids, 0)]
        rows = rows * held[..., None].to(rows.dtype)
        for i in cuts:
            rows = _CombineOverEp.apply(rows, mesh.get_group(i), False)
        return rows
    return local_map(local, out_placements=(bpl,),
                     in_placements=(table.placements, bpl),
                     in_grad_placements=(tgrad, bpl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def _put(cache: torch.Tensor, pos: int, new: torch.Tensor) -> None:
    """``cache[:, pos] = new`` in place.  On a DTensor cache (its
    sequence cut over "model", or over every axis for a batch that does
    not divide) the rank whose block holds ``pos`` writes ``new`` there,
    placed as the cache without its sequence dim; DTensor has no
    in-place rule for a write into a cut dimension."""
    if not isinstance(cache, DTensor):
        cache[:, pos] = new.to(cache.dtype)
        return
    place = [Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard)
             and p.dim != 1 else Replicate() for p in cache.placements]
    new = new.redistribute(cache.device_mesh, place).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, cache.device_mesh, cache.placements)
    at = pos - offset[1]
    if 0 <= at < shape[1]:
        cache.to_local()[:, at] = new.to(cache.dtype)


def pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, S, ...) -> (B, S + pad, ...), zeros after the last position (a
    new tensor).  On a DTensor whose sequence dim is not cut each rank
    pads its own block: DTensor's rule for ``F.pad`` cannot plan the
    redistribution of a block cut over "model" in some releases
    (torch 2.11)."""
    widths = (0, 0) * (t.dim() - 2) + (0, pad)
    if not isinstance(t, DTensor):
        return F.pad(t, widths)
    if any(isinstance(p, Shard) and p.dim == 1 for p in t.placements):
        raise ValueError("pad_seq: the sequence dim is cut")
    shape = (t.shape[0], t.shape[1] + pad) + tuple(t.shape[2:])
    return DTensor.from_local(
        F.pad(t.to_local(), widths), t.device_mesh, t.placements,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


# --------------------------------------------------------------------------
# Basic ops
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, n_heads, head_dim); positions:
    (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs            # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
               prefix_len: int, causal: bool) -> torch.Tensor:
    """Boolean (..., Sq, Sk) mask. True = attend."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    if causal:
        m = kp <= qp
        if window:
            m &= kp > qp - window
        if prefix_len:
            m |= (qp < prefix_len) & (kp < prefix_len)
    else:
        m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                       dtype=torch.bool, device=qp.device)
    return m


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd).  A DTensor whose last dim is cut
    over more ranks than divide ``n`` is gathered along it first (its
    gradient cut back in the backward): DTensor has no rule for a view
    that splits a cut dim unevenly."""
    if isinstance(t, DTensor):
        cut = [i for i, p in enumerate(t.placements)
               if p == Shard(t.dim() - 1)]
        if n % math.prod(t.device_mesh.size(i) for i in cut):
            t = t.redistribute(t.device_mesh, [
                Replicate() if i in cut else p
                for i, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:-1], n, hd)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, n, hd) -> (B, S, n * hd).  On a DTensor the gradient is
    placed as the value before the view's backward splits it again (it
    may arrive cut over more ranks than divide n)."""
    out = t.reshape(*t.shape[:-2], -1)
    return _Place.apply(out, out.placements) \
        if isinstance(out, DTensor) else out


def _attend(cfg: ArchConfig, q, k, v, q_norm, k_norm, positions, *,
            window: int, prefix_len: int, causal: bool, cross: bool,
            kv_index: Optional[torch.Tensor] = None):
    """The attention core after the projections: q (B, S, H, hd), k/v
    (B, Sk, K, hd) -> (out (B, S, H, hd), k, v), k and v normed and
    rotated as the cache keeps them.  ``positions`` has one row per batch
    row or one for all.  ``kv_index`` names each q head's kv head where
    the kv heads are not in q's groups (a rank holding some q heads of
    every kv head)."""
    B, S, H, hd = q.shape
    if cfg.qk_norm:
        q = rms_norm(q, q_norm)
        if not cross:
            k = rms_norm(k, k_norm)
    if cfg.use_rope and not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    kk, vv = k, v
    if kv_index is not None:
        kk, vv = k.index_select(2, kv_index), v.index_select(2, kv_index)
    K = kk.shape[2]
    q = q.reshape(B, S, K, H // K, hd)
    k_pos = torch.arange(k.shape[1], device=q.device)[None] if cross \
        else positions
    scale = hd ** -0.5
    sm_dt = getattr(torch, cfg.attn_softmax_dtype)
    scores = torch.einsum("bskgh,btkh->bkgst", q, kk) * scale
    mask = _attn_mask(positions, k_pos, window, prefix_len, causal)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores.to(sm_dt), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, vv)
    return out.reshape(B, S, H, hd), k, v


def _attend_blocks(cfg: ArchConfig, q, k, v, q_norm, k_norm, positions,
                   **kw):
    """``_attend`` on each rank's blocks: the batch cut over the dp axes
    where they divide it, the q heads over "model" where it divides
    them, the kv heads with them where it divides those too (each rank
    then holds whole groups), else every kv head on every rank, each q
    head reading its own (``kv_index``).  The dims DTensor would have to
    propagate through the two 5-d einsums instead, on a 3-axis mesh,
    take it minutes a layer."""
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    bpl, gpl = _batch_placements(mesh, q.shape[0])
    H, K = q.shape[2], k.shape[2]
    tp = mesh.size(names.index("model")) if "model" in names else 1
    q_cut = H % tp == 0 and tp > 1
    kv_cut = q_cut and K % tp == 0

    def place(cut, partial_when_uncut):
        return tuple(Shard(2) if a == "model" and cut else
                     Partial() if a == "model" and partial_when_uncut
                     else b for a, b in zip(names, bpl))
    qpl, kvpl = place(q_cut, False), place(kv_cut, False)
    kvgrad = place(kv_cut, q_cut)       # kv read by this rank's q heads
    wgrad = tuple(Partial() if a == "model" and q_cut else g
                  for a, g in zip(names, gpl))
    kv_index = None
    if q_cut and not kv_cut:
        Hl = H // tp
        h0 = mesh.get_local_rank("model") * Hl
        kv_index = torch.div(torch.arange(h0, h0 + Hl, device=q.device),
                             H // K, rounding_mode="floor")
    rep = (Replicate(),) * mesh.ndim
    norms = [t for t in (q_norm, k_norm) if t is not None]

    def local(ql, kl, vl, *ns):
        qn = ns[0] if q_norm is not None else None
        kn = ns[-1] if k_norm is not None else None
        return _attend(cfg, ql, kl, vl, qn, kn, positions[:1],
                       kv_index=kv_index, **kw)
    return local_map(local, out_placements=(qpl, kvpl, kvpl),
                     in_placements=(qpl, kvpl, kvpl) + (rep,) * len(norms),
                     in_grad_placements=(qpl, kvgrad, kvgrad)
                     + (wgrad,) * len(norms),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, *norms)


def attention(p: Dict[str, torch.Tensor], cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *, window: int = 0,
              prefix_len: int = 0,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True, return_kv: bool = False):
    """Full-sequence attention (prefill, the encoder, cross-attention).

    x: (B, S, D).  kv_override: use these (B, Sk, K, hd) tensors as K/V
    (cross-attention: only q is normed, no rope, key positions
    0..Sk-1); otherwise K/V are projected from x.  On DTensors the core
    runs on each rank's blocks (``_attend_blocks``); every row of
    ``positions`` is then the same (as ``forward`` makes them)."""
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_heads(x @ p["wq"], H, hd)
    cross = kv_override is not None
    if cross:
        k, v = kv_override
    else:
        k = split_heads(x @ p["wk"], K, hd)
        v = split_heads(x @ p["wv"], K, hd)
    attend = _attend_blocks if isinstance(x, DTensor) else _attend
    out, k, v = attend(cfg, q, k, v, p.get("q_norm") if cfg.qk_norm
                       else None, p.get("k_norm") if cfg.qk_norm and
                       not cross else None, positions, window=window,
                       prefix_len=prefix_len, causal=causal, cross=cross)
    out = _merge_heads(out) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p: Dict[str, torch.Tensor], cfg: ArchConfig,
                     x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, *, window: int = 0,
                     cross_kv: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None):
    """Single-token decode.  x: (B, 1, D); cache: (B, Smax, K, hd); pos:
    host int, the index where the new token's K/V is written.  The cache
    is updated IN PLACE (the reference returns an updated copy); the
    same tensors are returned.  The attention core is the decode kernel,
    whose contract (``decode_attention_ref``) keeps the probabilities in
    float32 up to the value product; the reference's inline version
    casts them to x's dtype first, which agrees to rounding in float32
    and within the kernel tolerance in bfloat16.

    For cross-attention (the whisper decoder) pass ``cross_kv``: no
    cache is written, no rope or k norm applied, and every one of its Sk
    keys is valid, so the kernel attends at position Sk - 1 with no
    window (the reference's all-true mask).  Returns (out, cache_k,
    cache_v)."""
    B, _, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    # on DTensors q keeps every head: the attention core places it as the
    # cache without its sequence dim (each rank's kv heads whole)
    q = pin_batch(x @ p["wq"]).reshape(B, 1, K, G, hd)
    if cross_kv is not None:
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
        keys, vals = cross_kv
        out = decode_ops.decode_attention(q.reshape(B, K, G, hd), keys,
                                          vals, keys.shape[1] - 1, 0)
        return out.reshape(B, 1, H * hd) @ p["wo"], cache_k, cache_v
    k = split_heads(x @ p["wk"], K, hd)
    v = split_heads(x @ p["wv"], K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.use_rope:
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q.reshape(B, 1, H, hd), posb, cfg.rope_theta) \
            .reshape(B, 1, K, G, hd)
        k = rope(k, posb, cfg.rope_theta)
    _put(cache_k, pos, k[:, 0])
    _put(cache_v, pos, v[:, 0])
    out = decode_ops.decode_attention(q.reshape(B, K, G, hd), cache_k,
                                      cache_v, pos, window)
    return out.reshape(B, 1, H * hd) @ p["wo"], cache_k, cache_v


# --------------------------------------------------------------------------
# Dense MLP
# --------------------------------------------------------------------------
def mlp(p: Dict[str, torch.Tensor], cfg: ArchConfig,
        x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or GELU in ``jax.nn.gelu``'s default tanh form (the erf
    form differs from it by up to 4.7e-4)."""
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return F.gelu(x @ p["wi"], approximate="tanh") @ p["wo_mlp"]


# --------------------------------------------------------------------------
# Mixture-of-Experts
# --------------------------------------------------------------------------
def _experts(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T, D) times every expert's (E, D, F) -> (E, T, F): one batched
    product, with no copy of the expert weights."""
    return torch.matmul(x.unsqueeze(0), w)


def moe_dense(p: Dict[str, torch.Tensor], cfg: ArchConfig,
              x: torch.Tensor) -> torch.Tensor:
    """Reference MoE: computes EVERY expert for every token, then keeps
    the top k by their router weights (what the reference's server
    runs)."""
    B, S, D = x.shape
    k = cfg.num_experts_per_tok
    xf = x.reshape(B * S, D)
    router = p["router"]
    logits = xf.to(router.dtype) @ router        # JAX: bf16 @ f32 -> f32
    # the router writes the dense combine weights (T, E) in x's dtype,
    # the reference's dense_w.at[...].set(w).astype(x.dtype)
    _, _, dense_w = route_ops.route_dense(logits, k, cfg.moe_renormalize,
                                          x.dtype)
    g = _experts(xf, p["wg"])                    # (E, T, F)
    u = _experts(xf, p["wu"])
    y = torch.bmm(F.silu(g) * u, p["wd"])        # (E, T, D)
    out = torch.einsum("te,etd->td", dense_w, y)
    return out.reshape(B, S, D)


class _FromEpGroup(torch.autograd.Function):
    """Identity forward; the backward sums each gradient over the ep
    group.  The transpose of the reference's ``shard_map`` in-specs for
    inputs replicated over the ep axis (x, the router): each ep rank's
    gradient holds only its own experts' share."""

    @staticmethod
    def forward(ctx, group, *ts):
        ctx.group = group
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            if g is not None:
                g = g.contiguous()
                dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


class _CombineOverEp(torch.autograd.Function):
    """The combine of the ep ranks' partial outputs (T, D): an all-reduce
    in the partials' dtype, or (``scatter_gather``) a reduce-scatter in
    it and an all-gather in bfloat16.  Every ep rank then runs the same
    downstream, so the backward is the identity."""

    @staticmethod
    def forward(ctx, out, group, scatter_gather: bool):
        ctx.dtype = out.dtype
        if scatter_gather:
            n = dist.get_world_size(group)
            chunk = out.new_empty((out.shape[0] // n,) + out.shape[1:])
            dist.reduce_scatter_tensor(chunk, out.contiguous(), group=group)
            full = out.new_empty(out.shape, dtype=torch.bfloat16)
            dist.all_gather_into_tensor(full, chunk.to(torch.bfloat16),
                                        group=group)
            return full
        out = out.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


def _take_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` with a zero row where ``idx == len(src)``."""
    n = src.shape[0]
    out = src.index_select(0, idx.clamp(max=n - 1))
    return out.masked_fill_((idx >= n)[:, None], 0)


def _sum_rows(src: torch.Tensor, pair_slot: torch.Tensor) -> torch.Tensor:
    """(T, k) -> (T, D): each token's sum of ``src``'s rows at its k
    slots, added left to right (a slot of ``len(src)`` adds nothing)."""
    out = _take_rows(src, pair_slot[:, 0])
    for r in range(1, pair_slot.shape[1]):
        out.add_(_take_rows(src, pair_slot[:, r]))
    return out


class _TokensToSlots(torch.autograd.Function):
    """The dispatch gather ``x[buf_tok]`` (an empty slot reads zeros).
    Its transpose is ``_SlotsToTokens``: every filled slot holds one
    (token, expert) pair, so both directions are gathers.  (Autograd's
    own backward of the gather scatter-adds every empty slot into one
    spill row, one after another.)"""

    @staticmethod
    def forward(ctx, x, buf_tok, pair_slot):
        ctx.save_for_backward(pair_slot)
        return _take_rows(x, buf_tok)

    @staticmethod
    def backward(ctx, g):
        pair_slot, = ctx.saved_tensors
        return _sum_rows(g, pair_slot), None, None


class _SlotsToTokens(torch.autograd.Function):
    """The combine: each token's sum of its slots' rows in ``pair_slot``
    order; the transpose of ``_TokensToSlots``."""

    @staticmethod
    def forward(ctx, rows, pair_slot, buf_tok):
        ctx.save_for_backward(buf_tok)
        return _sum_rows(rows, pair_slot)

    @staticmethod
    def backward(ctx, g):
        buf_tok, = ctx.saved_tensors
        return _take_rows(g, buf_tok), None, None


def moe_capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` local tokens: ``k T / E`` times
    ``capacity_factor``, rounded up to 8, at least 8, at most T."""
    cap = int(tokens * cfg.num_experts_per_tok / cfg.num_experts
              * cfg.capacity_factor)
    cap = max(8, -(-cap // 8) * 8)
    return min(cap, tokens)


def moe_dispatch(idx: torch.Tensor, E: int, cap: int, lo: int, El: int):
    """Sort-based dispatch of one rank's (T, k) ids of E experts to its
    experts ``lo .. lo + El - 1``, ``cap`` slots each, as the reference's
    ``moe_ep`` computes it: ``order`` (T * k,), the flat (token, expert)
    pairs sorted by expert (stable); ``slot`` (T * k,), each sorted
    pair's slot, or ``El * cap`` (the spill slot past the end) where the
    pair is another rank's or past its expert's capacity; ``buf_tok``
    (El * cap,), the token in each slot (``T`` where it is empty);
    ``counts`` (E,), the pairs routed to each expert; and ``pair_slot``
    (T, k), each token's slots in ascending expert order (``El * cap``
    where the pair has none), the order in which the reference's
    scatter-add reaches them."""
    T, k = idx.shape
    eid = idx.reshape(-1).long()
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    # a scatter-add, not bincount: on CUDA bincount reads its max on the host
    counts = torch.zeros(E, dtype=torch.long, device=idx.device) \
        .scatter_add_(0, eid, torch.ones_like(eid))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=idx.device) - offsets[sorted_eid]
    local = (sorted_eid >= lo) & (sorted_eid < lo + El) & (rank < cap)
    slot = torch.where(local, (sorted_eid - lo) * cap + rank, El * cap)
    # the reference sets at El * cap inside a buffer one longer and cuts
    # it; scatter_drop sends that index to its own spill slot
    buf_tok = scatter_drop(torch.full((El * cap,), T, dtype=torch.long,
                                      device=idx.device), slot, order // k)
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    by_expert = torch.argsort(idx, dim=1)       # a token's experts differ
    pair_slot = torch.gather(pair_slot.reshape(T, k), 1, by_expert)
    return order, slot, buf_tok, counts, pair_slot


# Set to a list to record the dispatch (chip_smoke and the tests do):
# moe_ep then appends, per call, ``(buf_tok, counts, cap, lo, El)``, its
# own dispatch's slot tokens and per-expert pair counts (device tensors)
# and this rank's capacity and expert range.
DISPATCH = None


def dropped_pairs(record) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's dropped (token, expert) pairs and all its pairs in one
    ``DISPATCH`` record, as 0-d tensors."""
    _, counts, cap, lo, El = record
    mine = counts[lo:lo + El]
    return (mine - cap).clamp(min=0).sum(), mine.sum()


def moe_ep(p: Dict[str, torch.Tensor], cfg: ArchConfig, x: torch.Tensor, *,
           mesh, ep_axis: str) -> torch.Tensor:
    """Expert-parallel MoE, one rank's part of the reference's
    ``shard_map``: ``x`` (B, S, D) is this rank's batch block (all of the
    batch when it is not sharded) and ``p`` holds this rank's ``El = E /
    ep`` experts (``wg``/``wu`` (El, D, F), ``wd`` (El, F, D); the
    router whole).

    Dispatch is sort-based with a static per-expert capacity from the
    local token count (``moe_capacity``): a (token, expert) pair past its
    expert's last slot is dropped.  The router is the moe_route kernel
    (``route_ops.route_dense``; its dense weights are not used).  Each
    rank computes its experts on their slots (three ``bmm``), sums each
    token's weighted slot rows in ``moe_psum_dtype`` in the reference's
    scatter-add order (``_SlotsToTokens``), and the partial outputs are
    combined over the ep group (``_CombineOverEp``).  The reference also
    takes ``dp_axes`` and ``batch_sharded``, which say how ``x`` was
    cut; here ``x`` is already this rank's block and the capacity needs
    only its size.

    On DTensors the layer runs through ``local_map`` with the
    reference's ``shard_map`` specs: the router whole, the experts cut
    over ``ep_axis`` (all-gathered over "data", where the placement map
    cuts them for FSDP), ``x`` cut over the dp axes where they divide
    the batch; the router's and the experts' gradients come back as
    partial sums over those axes."""
    if isinstance(x, DTensor):
        return _moe_ep_blocks(p, cfg, x, mesh, ep_axis)
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    group = mesh.get_group(ep_axis)
    ep_size = dist.get_world_size(group)
    j = mesh.get_local_rank(ep_axis)
    if E % ep_size:
        raise ValueError(f"{E} experts over an ep axis of {ep_size}")
    El = E // ep_size
    if p["wg"].shape[0] != El:
        raise ValueError(f"moe_ep takes this rank's {El} experts; got "
                         f"{p['wg'].shape[0]}")
    B, S, D = x.shape
    T = B * S
    cap = moe_capacity(cfg, T)
    xf, router = _FromEpGroup.apply(group, x.reshape(T, D), p["router"])
    logits = xf.to(router.dtype) @ router        # JAX: bf16 @ f32 -> f32
    w, idx, _ = route_ops.route_dense(logits, k, cfg.moe_renormalize,
                                      torch.float32)
    lo = j * El
    order, slot, buf_tok, counts, pair_slot = moe_dispatch(idx, E, cap, lo,
                                                           El)
    if DISPATCH is not None:
        DISPATCH.append((buf_tok, counts, cap, lo, El))
    xg = _TokensToSlots.apply(xf, buf_tok, pair_slot).reshape(El, cap, D)
    g = torch.bmm(xg, p["wg"])
    u = torch.bmm(xg, p["wu"])
    y = torch.bmm(F.silu(g) * u, p["wd"])        # (El, cap, D)
    wslot = scatter_drop(torch.zeros(El * cap, dtype=torch.float32,
                                     device=x.device),
                         slot, w.reshape(-1)[order])
    yw = y.reshape(El * cap, D) * wslot[:, None].to(y.dtype)
    psum_dt = getattr(torch, cfg.moe_psum_dtype)
    out = _SlotsToTokens.apply(yw.to(psum_dt), pair_slot, buf_tok)
    scatter_gather = (cfg.moe_combine == "scatter_gather"
                      and T % ep_size == 0 and ep_size > 1)
    out = _CombineOverEp.apply(out, group, scatter_gather)
    return out.to(x.dtype).reshape(B, S, D)


def _moe_ep_blocks(p, cfg: ArchConfig, x: DTensor, mesh,
                   ep_axis: str) -> DTensor:
    bpl, gpl = _batch_placements(mesh, x.shape[0])
    ep = mesh.mesh_dim_names.index(ep_axis)
    rep = (Replicate(),) * mesh.ndim
    epl = tuple(Shard(0) if i == ep else Replicate()
                for i in range(mesh.ndim))
    egrad = tuple(Shard(0) if i == ep else g for i, g in enumerate(gpl))

    def local(router, wg, wu, wd, xl):
        return moe_ep({"router": router, "wg": wg, "wu": wu, "wd": wd},
                      cfg, xl, mesh=mesh, ep_axis=ep_axis)
    return local_map(local, out_placements=(bpl,),
                     in_placements=(rep, epl, epl, epl, bpl),
                     in_grad_placements=(gpl, egrad, egrad, egrad, bpl),
                     device_mesh=mesh, redistribute_inputs=True)(
        p["router"], p["wg"], p["wu"], p["wd"], x)


# --------------------------------------------------------------------------
# Mamba2 (SSD) block
# --------------------------------------------------------------------------
def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``.  No torch formula
    gives XLA's CPU bits everywhere; this one is the closest (float32
    over [-30, 30]: 3,229 of 200,001 points differ, by at most 2.4e-7,
    where ``F.softplus`` differs on 6,169 by up to 9.5e-7: it switches to
    the identity above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (K, C); b: (C,).  The
    reference's shifted sum in x's dtype, in its order (a grouped
    ``conv1d`` would sum in another order, and in TF32 on the card)."""
    Kk = w.shape[0]
    w = w.to(x.dtype)
    b = b.to(x.dtype)
    xp = F.pad(x, (0, 0, Kk - 1, 0))
    S = x.shape[1]
    acc = torch.zeros_like(x)
    for i in range(Kk):
        acc = acc + xp[:, i:i + S, :] * w[i]
    return acc + b


def ssd_block(p: Dict[str, torch.Tensor], cfg: ArchConfig, x: torch.Tensor):
    """Mamba2 block (prefill). x: (B,S,D) -> (out (B,S,D), (conv_tail
    (B, K-1, d_inner+2N), final_state (B,H,P,N) float32)).  The scan is
    the SSD kernel; xs, Bm and Cm go to it as strided slices of the conv
    output.  On DTensors it runs on each rank's batch block
    (``dp_blocks``)."""
    if isinstance(x, DTensor):
        return dp_blocks(lambda pp, xx: ssd_block(pp, cfg, xx), p, x)
    B, S, D = x.shape
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    Pd = cfg.ssm_headdim
    zxbcdt = x @ p["in_proj"]
    z, xbc_raw, dt = torch.split(zxbcdt, [din, din + 2 * N, H], dim=-1)
    xbc = F.silu(causal_conv1d(xbc_raw, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = torch.split(xbc, [din, N, N], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    xs = xs.reshape(B, S, H, Pd)
    y, final_state = ssd_ops.ssd_scan(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = y.reshape(B, S, din)
    y = rms_norm(y * F.silu(z), p["ssm_norm"])
    conv_tail = xbc_raw[:, -(cfg.ssm_conv - 1):, :]
    return y @ p["out_proj"], (conv_tail, final_state)


def ssd_decode(p: Dict[str, torch.Tensor], cfg: ArchConfig, x: torch.Tensor,
               conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """Single-token SSD recurrence.  x: (B,1,D); conv_state: (B, K-1, C);
    ssm_state: (B,H,Pd,N) float32.  Returns (out (B,1,D), conv_state,
    ssm_state), new tensors (the caller writes them into its cache)."""
    if isinstance(x, DTensor):
        return dp_blocks(lambda pp, *a: ssd_decode(pp, cfg, *a), p, x,
                         conv_state, ssm_state)
    B, _, D = x.shape
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    Pd = cfg.ssm_headdim
    zxbcdt = x[:, 0] @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * N, H], dim=-1)
    full = torch.cat([conv_state, xbc[:, None, :]], dim=1)     # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", full,
                            p["conv_w"].to(full.dtype)) \
        + p["conv_b"].to(full.dtype)
    xbc_c = F.silu(conv_out)
    xs, Bm, Cm = torch.split(xbc_c, [din, N, N], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])                     # (B,H)
    A = -torch.exp(p["A_log"].float())
    xs = xs.reshape(B, H, Pd)
    dA = torch.exp(dt * A)                                       # (B,H)
    inp = (dt[..., None] * xs).float()                           # (B,H,Pd)
    new_state = dA[..., None, None] * ssm_state \
        + inp[..., None] * Bm[:, None, None, :].float()
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())       # (B,H,Pd)
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(B, din).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["ssm_norm"])
    out = (y @ p["out_proj"])[:, None, :]
    return out, full[:, 1:, :], new_state
