"""Analytic roofline terms: MODEL_FLOPS, memory model, hardware constants;
a copy of ``repro.launch.analytic`` with the same arithmetic and the
card's constants.

MODEL_FLOPS follows the assignment: 6·N·D (dense) / 6·N_active·D (MoE) for
training, 2·N·D for forward-only, where N excludes the embedding gather
(the tied/untied LM head matmul IS included) and D is tokens processed.
Attention score FLOPs are reported separately (they are not part of 6ND).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeConfig

# --- NVIDIA H100 SXM5 80 GB constants (per card) --------------------------
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s (data sheet)
HBM_BW = 3.35e12             # HBM3 bytes/s (data sheet)
ICI_BW = 450e9               # NVLink 4 bytes/s per direction (data sheet)
HBM_BYTES = 85017493504      # torch.cuda.get_device_properties(0).total_memory
                             # on an NVIDIA H100 80GB HBM3 (81,559 MiB)


def _dtype_bytes(name: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2}[name]


def effective_params(cfg: ArchConfig) -> Dict[str, float]:
    total, active = cfg.param_counts()
    embed = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else 0  # head matmul params stay counted
    return {"total": total, "active": active,
            "matmul_total": total - embed,       # embedding gather excluded
            "matmul_active": active - embed}


def attn_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Score+AV matmul FLOPs (forward), honoring causality and windows."""
    B, Sq = shape.global_batch, shape.seq_len
    H, hd = cfg.num_heads, cfg.head_dim
    if H == 0:
        return 0.0
    fl = 0.0
    for spec in cfg.layer_plan():
        if spec.kind != "attn":
            continue
        if shape.step == "decode":
            ctx = min(spec.window, Sq) if spec.window else Sq
            fl += 4.0 * B * ctx * H * hd
        else:
            if spec.window and spec.window < Sq:
                ctx = 2.0 * B * Sq * spec.window * H * hd
            else:
                ctx = 2.0 * B * Sq * Sq * H * hd  # causal: S^2/2 * 4
            fl += ctx * (3 if shape.step == "train" else 1)
    return fl


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, float]:
    p = effective_params(cfg)
    n = p["matmul_active"]
    if shape.step == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n * tokens
    elif shape.step == "prefill":
        tokens = shape.global_batch * shape.seq_len
        base = 2.0 * n * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        base = 2.0 * n * tokens
    return {"model_flops": base, "attn_flops": attn_flops(cfg, shape),
            "tokens": tokens}


def kv_cache_bytes(cfg: ArchConfig, batch: int, seq: int) -> float:
    pb = _dtype_bytes(cfg.param_dtype)
    total = 0.0
    for spec in cfg.layer_plan():
        if spec.kind == "attn":
            total += 2 * batch * seq * cfg.num_kv_heads * cfg.head_dim * pb
        else:
            total += batch * cfg.ssm_heads * cfg.ssm_headdim \
                * cfg.ssm_state * 4
            total += batch * (cfg.ssm_conv - 1) \
                * (cfg.d_inner + 2 * cfg.ssm_state) * pb
    if cfg.enc_dec:
        total += 2 * cfg.num_layers * batch * cfg.num_prefix_tokens \
            * cfg.num_kv_heads * cfg.head_dim * pb
    return total


def kernelized_bytes(cfg: ArchConfig, shape: ShapeConfig, dp: int,
                     tp: int) -> float:
    """Per-device HBM-traffic FLOOR assuming fused kernels keep attention
    scores and SSD decay/scan intermediates on chip (shared memory and
    registers; the port's decode_attention and ssd_scan kernels do
    exactly this; flash-forward for training follows the same tiling).
    Counts: weights (fwd + remat recompute + bwd) + optimizer update +
    per-layer activation I/O + flash-attention Q/K/V/O + logits.

    The dry run's "bytes accessed" of the unfused step is the matching
    upper bound; a card sits between the two, near this floor when the
    hot loops are kernelized."""
    p = effective_params(cfg)
    pb = _dtype_bytes(cfg.param_dtype)
    ob = _dtype_bytes(cfg.opt_dtype)
    shard = dp * tp
    train = shape.step == "train"
    w = p["total"] * pb / shard * (3.0 if train else 1.0)
    if train:
        w += p["total"] * (2.0 * pb + 6.0 * ob) / shard  # grads + adam
    B, Sq = shape.global_batch, shape.seq_len
    b_loc = max(B // dp, 1)
    toks = b_loc * (Sq if shape.step != "decode" else 1)
    passes = 8.0 if train else 3.0          # resid/norm/proj I/O per layer
    act = cfg.num_layers * toks * cfg.d_model * pb * passes
    if cfg.num_heads:
        kv_ctx = B * Sq * cfg.num_kv_heads * cfg.head_dim * 2 * pb \
            / (dp * tp) if shape.step == "decode" else 0.0
        qkvo = cfg.num_layers * toks * (2 * cfg.num_heads
                                        + 2 * cfg.num_kv_heads) \
            * cfg.head_dim * pb * (3.0 if train else 1.0)
        act += qkvo + kv_ctx * cfg.num_layers / max(cfg.num_layers, 1)
        if shape.step == "decode":
            act += kv_cache_bytes(cfg, B, Sq) / shard
    logits = toks * cfg.vocab_size * 4.0 / tp * (2.0 if train else 1.0)
    return w + act + logits


def analytic_memory(cfg: ArchConfig, shape: ShapeConfig,
                    n_chips: int, dp: int, tp: int) -> Dict[str, float]:
    """Per-device bytes under the baseline sharding policy (params & opt
    2-D sharded over data×model; activations remat'd to layer boundaries)."""
    p = effective_params(cfg)
    pb = _dtype_bytes(cfg.param_dtype)
    ob = _dtype_bytes(cfg.opt_dtype)
    shard = dp * tp
    params_dev = p["total"] * pb / shard
    opt_dev = 2.0 * p["total"] * ob / shard
    if shape.step == "train":
        b_loc = max(shape.global_batch // dp, 1)
        # remat: per-layer boundary activation + logits in f32 + workspace
        act = cfg.num_layers * b_loc * shape.seq_len * cfg.d_model * pb
        act += b_loc * shape.seq_len * cfg.vocab_size * 4 / tp
        grads_dev = p["total"] * pb / shard
        cache_dev = 0.0
    else:
        b_loc = max(shape.global_batch // dp, 1)
        act = 2 * b_loc * min(shape.seq_len, 32768) * cfg.d_model * pb
        grads_dev = 0.0
        cache_dev = kv_cache_bytes(cfg, shape.global_batch,
                                   shape.seq_len) / n_chips
    return {"params": params_dev, "opt": opt_dev, "grads": grads_dev,
            "activations": act, "kv_cache": cache_dev,
            "total": params_dev + opt_dev + grads_dev + act + cache_dev,
            "fits_h100": (params_dev + opt_dev + grads_dev + act + cache_dev)
            < HBM_BYTES}
