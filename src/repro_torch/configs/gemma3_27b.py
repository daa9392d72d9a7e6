"""gemma3-27b — dense, 5:1 local:global sliding-window attention.

[hf:google/gemma-3-1b-pt; unverified]  62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144.  Pattern of 6: five local (window 1024) layers
then one global layer; 62 = 10*6 + 2 remainder local layers.  head_dim=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    source="[hf:google/gemma-3-1b-pt; unverified]",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    qk_norm=True,
    sliding_window=1024,
    local_global_period=6,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
