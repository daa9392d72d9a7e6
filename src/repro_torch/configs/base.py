"""Architecture and shape configuration, a copy of
``repro.configs.base``.

It keeps the fields and methods that the port's serving and training
paths read (``layer_plan``, ``encoder_plan``, ``plan_blocks``,
``param_counts``, ``reduced``; the expert-parallel MoE's
``capacity_factor``, ``moe_psum_dtype`` and ``moe_combine``), and the
input shapes (``ShapeConfig``, ``SHAPES``, ``applicable_shapes``), with
the reference's defaults, so that a config built here and one built
there describe the same model.  Left out: ``ssd_compute_dtype`` (a TPU
tuning knob that no config sets; the port's scan computes in float32,
its default).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple


@dataclass(frozen=True)
class LayerSpec:
    kind: str            # "attn" | "ssm"
    moe: bool            # MoE MLP instead of dense MLP
    window: int          # sliding-window size; 0 = full attention
    cross_attn: bool = False


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    source: str = ""

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    mlp_type: str = "swiglu"
    tie_embeddings: bool = True

    qk_norm: bool = False
    use_rope: bool = True
    rope_theta: float = 10_000.0
    sliding_window: int = 0
    local_global_period: int = 0
    attn_layer_period: int = 0
    attn_layer_offset: int = 0

    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1
    first_dense_layers: int = 0
    moe_renormalize: bool = True
    capacity_factor: float = 1.25  # moe_ep's slots per expert over k T / E

    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4

    enc_dec: bool = False
    num_encoder_layers: int = 0
    frontend: str = ""             # "" | "vision_stub" | "audio_stub"
    num_prefix_tokens: int = 0     # vlm: image patches; audio: frames

    param_dtype: str = "bfloat16"
    opt_dtype: str = "float32"     # AdamW m/v dtype ("bfloat16" to halve it)
    remat: bool = True             # each superblock under checkpoint
    remat_policy: str = "nothing"  # "nothing" | "dots" (save the mm outputs)
    attn_softmax_dtype: str = "float32"
    moe_psum_dtype: str = "float32"      # moe_ep's scatter-add and combine
    moe_combine: str = "allreduce"       # "scatter_gather": RS(f32)+AG(bf16)

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_plan(self) -> List[LayerSpec]:
        plan: List[LayerSpec] = []
        for i in range(self.num_layers):
            if self.num_heads == 0:
                kind = "ssm"
            elif self.attn_layer_period:
                kind = ("attn" if i % self.attn_layer_period
                        == self.attn_layer_offset else "ssm")
            else:
                kind = "attn"
            moe = (self.num_experts > 0
                   and i >= self.first_dense_layers
                   and (i - self.first_dense_layers)
                   % self.moe_layer_period == 0)
            window = 0
            if self.sliding_window:
                if self.local_global_period:
                    is_global = (i % self.local_global_period
                                 == self.local_global_period - 1)
                    window = 0 if is_global else self.sliding_window
                else:
                    window = self.sliding_window
            plan.append(LayerSpec(kind=kind, moe=moe, window=window))
        return plan

    def encoder_plan(self) -> List[LayerSpec]:
        return [LayerSpec(kind="attn", moe=False, window=0)
                for _ in range(self.num_encoder_layers)]

    def plan_blocks(self) -> Tuple[int, int, int, int]:
        """(head, period, n_super, tail): ``head`` leading layers, then
        ``n_super`` repetitions of a ``period``-layer superblock (stacked
        params), then ``tail`` partial-period layers."""
        plan = self.layer_plan()
        head = self.first_dense_layers if self.num_experts > 0 else 0
        rest = plan[head:]
        p = len(rest) if rest else 1
        for cand in range(1, len(rest) + 1):
            if all(rest[i] == rest[i % cand] for i in range(len(rest))):
                p = cand
                break
        n_super = len(rest) // p if p else 0
        tail = len(rest) - n_super * p
        return head, p, n_super, tail

    def param_counts(self) -> Tuple[int, int]:
        """(total_params, active_params); active counts the top-k
        experts only."""
        D, V = self.d_model, self.vocab_size
        total = V * D * (1 if self.tie_embeddings else 2)
        active = total

        def attn_params():
            qk = D * self.num_heads * self.head_dim
            kv = D * self.num_kv_heads * self.head_dim
            return qk * 2 + kv * 2  # wq, wo, wk, wv

        def mlp_params(ff):
            n = 3 if self.mlp_type == "swiglu" else 2
            return n * D * ff

        def ssm_params():
            din, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            in_p = D * (2 * din + 2 * N + H)
            conv = self.ssm_conv * (din + 2 * N)
            return in_p + conv + 3 * H + din + din * D
        enc = self.encoder_plan() if self.enc_dec else []
        for spec in self.layer_plan() + enc:
            mixer = attn_params() if spec.kind == "attn" else ssm_params()
            total += mixer
            active += mixer
            if spec.moe:
                per_exp = mlp_params(self.moe_d_ff)
                total += self.num_experts * per_exp + D * self.num_experts
                active += (self.num_experts_per_tok * per_exp
                           + D * self.num_experts)
            elif self.d_ff:
                total += mlp_params(self.d_ff)
                active += mlp_params(self.d_ff)
        if self.enc_dec:  # decoder cross-attention blocks
            ca = (D * self.num_heads * self.head_dim) * 2 \
                + (D * self.num_kv_heads * self.head_dim) * 2
            total += self.num_layers * ca
            active += self.num_layers * ca
        return total, active

    def reduced(self, **overrides) -> "ArchConfig":
        """A test-sized config of the same family: the reference's
        ``reduced()`` values for the fields kept here."""
        small: Dict[str, Any] = dict(
            num_layers=min(self.num_layers, 4) or self.num_layers,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads
            else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            moe_d_ff=64 if self.num_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            num_encoder_layers=2 if self.enc_dec else 0,
            num_prefix_tokens=8 if self.num_prefix_tokens else 0,
            sliding_window=16 if self.sliding_window else 0,
            param_dtype="float32",
            capacity_factor=4.0,   # no token drops in tiny tests
        )
        if self.attn_layer_period:
            small["attn_layer_period"] = 4
            small["attn_layer_offset"] = 1
        if self.local_global_period:
            small["local_global_period"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)


# --------------------------------------------------------------------------
# Input shapes: every LM arch pairs with these four shapes.
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def long_context_ok(cfg: ArchConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (SSM, hybrid, or
    sliding-window dominated); pure full-attention archs skip it."""
    if cfg.num_heads == 0:              # pure SSM
        return True
    if cfg.attn_layer_period:           # hybrid (mostly SSM)
        return True
    if cfg.sliding_window and not cfg.enc_dec:
        return True                     # SWA-dominated (gemma3, danube)
    return False


def applicable_shapes(cfg: ArchConfig) -> List[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if long_context_ok(cfg):
        names.append("long_500k")
    return names
