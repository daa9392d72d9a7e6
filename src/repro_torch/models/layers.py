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

JAX promotes mixed float types at a product (``bf16 @ f32`` is an f32
product); PyTorch raises instead, so the casts JAX applies silently are
written out here (the router's logits, ``moe_dense``'s combine weights,
``rms_norm``'s f32 compute, the SSM blocks' float32 terms).
``jax.nn.gelu`` is the tanh approximation by default, and
``torch.nn.functional.gelu`` the exact erf form: ``mlp`` asks for the
tanh form.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import scatter_drop
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.moe_route import ops as route_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

NEG_INF = -2.0 ** 30  # large-negative for masking (safe in bf16)


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


def attention(p: Dict[str, torch.Tensor], cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, *, window: int = 0,
              prefix_len: int = 0,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              causal: bool = True, return_kv: bool = False):
    """Full-sequence attention (prefill, the encoder, cross-attention).

    x: (B, S, D).  kv_override: use these (B, Sk, K, hd) tensors as K/V
    (cross-attention: only q is normed, no rope, key positions
    0..Sk-1); otherwise K/V are projected from x."""
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    q = (x @ p["wq"]).reshape(B, S, K, G, hd)
    if kv_override is None:
        k = (x @ p["wk"]).reshape(B, S, K, hd)
        v = (x @ p["wv"]).reshape(B, S, K, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
            k = rms_norm(k, p["k_norm"])
        if cfg.use_rope:
            q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta) \
                .reshape(B, S, K, G, hd)
            k = rope(k, positions, cfg.rope_theta)
        k_pos = positions
    else:
        k, v = kv_override
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
        k_pos = torch.arange(k.shape[1], device=x.device).expand(
            B, k.shape[1])
    scale = hd ** -0.5
    sm_dt = getattr(torch, cfg.attn_softmax_dtype)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k) * scale
    mask = _attn_mask(positions, k_pos, window, prefix_len, causal)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores.to(sm_dt), dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v).reshape(B, S, H * hd)
    out = out @ p["wo"]
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
    q = (x @ p["wq"]).reshape(B, 1, K, G, hd)
    if cross_kv is not None:
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
        keys, vals = cross_kv
        out = decode_ops.decode_attention(q.reshape(B, K, G, hd), keys,
                                          vals, keys.shape[1] - 1, 0)
        return out.reshape(B, 1, H * hd) @ p["wo"], cache_k, cache_v
    k = (x @ p["wk"]).reshape(B, 1, K, hd)
    v = (x @ p["wv"]).reshape(B, 1, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.use_rope:
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q.reshape(B, 1, H, hd), posb, cfg.rope_theta) \
            .reshape(B, 1, K, G, hd)
        k = rope(k, posb, cfg.rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
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
    only its size."""
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
    output."""
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
