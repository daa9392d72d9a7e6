"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8.

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8)
d_ff=2048 (expert hidden) vocab=163840, MoE 384e top-8.  Per the
assignment table this uses GQA (not MLA); head_dim=128.  First layer is
dense (as in the released config).  AdamW state in bf16.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="[arXiv:2501.kimi2; unverified]",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,              # the single dense layer's hidden dim
    vocab_size=163840,
    num_experts=384,
    num_experts_per_tok=8,
    moe_d_ff=2048,
    moe_layer_period=1,
    first_dense_layers=1,
    tie_embeddings=False,
    opt_dtype="bfloat16",
)
