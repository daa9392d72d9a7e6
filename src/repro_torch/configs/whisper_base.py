"""whisper-base — encoder-decoder speech model; conv frontend STUB.

[arXiv:2212.04356; unverified]  6L (x2: encoder + decoder) d_model=512
8H (MHA kv=8) d_ff=2048 vocab=51865.  The conv1d+mel frontend is a stub:
``input_specs()`` provides precomputed frame embeddings (batch, 1500,
d_model) as encoder input.  GELU MLPs; learned positions approximated by
RoPE-free sinusoidal-equivalent (absolute pos handled by frontend stub).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    source="[arXiv:2212.04356; unverified]",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    mlp_type="gelu",
    use_rope=False,          # whisper uses absolute positions (frontend stub)
    enc_dec=True,
    num_encoder_layers=6,
    frontend="audio_stub",
    num_prefix_tokens=1500,
    tie_embeddings=True,
)
