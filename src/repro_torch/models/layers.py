"""Layer library of the port, twin of ``repro.models.layers`` for the
layers the serving paths run: attention (GQA / MQA, sliding window,
prefix-LM, cross-attention), the dense MLP, the MoE layer and the
Mamba2 (SSD) block.

Functions keep the reference's names, arguments and layouts.  Three of
them reach the port's kernels: ``attention_decode`` calls
``kernels.decode_attention.ops.decode_attention`` for its attention
core (self- and cross-attention alike), ``moe_dense`` takes its top-k
and its dense combine weights from ``kernels.moe_route.ops.route_dense``
(one launch) and ``ssd_block`` calls ``kernels.ssd_scan.ops.ssd_scan``
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
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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
