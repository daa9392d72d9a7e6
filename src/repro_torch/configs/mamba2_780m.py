"""mamba2-780m — attention-free SSM (SSD / state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=1536, no attention, no MLP
(d_ff=0: Mamba2 blocks only), vocab=50280, ssm_state=128.
d_inner = 2*1536 = 3072, headdim 64 -> 48 SSD heads.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    source="[arXiv:2405.21060; unverified]",
    num_layers=48,
    d_model=1536,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    d_ff=0,                  # Mamba2 blocks only
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    tie_embeddings=True,
)
