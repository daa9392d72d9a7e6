"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2.  Attention at offset 4 of each 8-layer
period; MoE on every second layer (as in the released Jamba block layout).
The SSM blocks use the Mamba2/SSD formulation (TPU-friendly chunked
matmuls); see docs/DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="[arXiv:2403.19887; hf]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    # hybrid interleave: 1 attention layer per 8 (1:7 attn:mamba)
    attn_layer_period=8,
    attn_layer_offset=4,
    # MoE: 16 experts, top-2, every other layer
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    # SSD block dims
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    tie_embeddings=False,
)
