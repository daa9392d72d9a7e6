"""olmoe-1b-7b — fully MoE transformer, 64 experts top-8.

[arXiv:2409.02060; hf]  16L d_model=2048 16H (GQA kv=16 == MHA)
d_ff=1024 (expert hidden) vocab=50304, MoE 64e top-8 on every layer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="[arXiv:2409.02060; hf]",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                  # every layer is MoE; no dense MLP
    vocab_size=50304,
    qk_norm=True,            # OLMoE uses QK-norm
    num_experts=64,
    num_experts_per_tok=8,
    moe_d_ff=1024,
    moe_layer_period=1,
    moe_renormalize=False,   # OLMoE does not renormalize top-k weights
    tie_embeddings=False,
)
