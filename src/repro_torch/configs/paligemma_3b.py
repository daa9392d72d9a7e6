"""paligemma-3b — VLM: SigLIP frontend (STUB) + gemma-2b text backbone.

[arXiv:2407.07726; hf]  18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216.  The SigLIP vision tower is a stub: ``input_specs()``
supplies precomputed patch embeddings (batch, 256, d_model) which are
prepended to the token embeddings (prefix-LM).  head_dim=256 (gemma-2b).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    source="[arXiv:2407.07726; hf]",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_type="gelu",
    frontend="vision_stub",
    num_prefix_tokens=256,
    tie_embeddings=True,
)
