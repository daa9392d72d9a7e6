"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

It holds the reference's ten architectures.  Five fit one 80 GB card in
bfloat16 and are served at full width; ``jamba-v0.1-52b``,
``llama3-405b`` and ``kimi-k2-1t-a32b`` do not (``param_counts``) and
run reduced.  ``LAISSEZCLOUD`` is the paper's own (market and cluster)
configuration."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (gemma3_27b, h2o_danube_1_8b, jamba_v0_1_52b,
                                 kimi_k2_1t_a32b, llama3_405b, mamba2_780m,
                                 olmoe_1b_7b, paligemma_3b, qwen3_0_6b,
                                 laissezcloud, whisper_base)
from repro_torch.configs.base import (SHAPES, ArchConfig, LayerSpec,
                                      ShapeConfig, applicable_shapes,
                                      long_context_ok)

_MODULES = [jamba_v0_1_52b, olmoe_1b_7b, kimi_k2_1t_a32b, gemma3_27b,
            llama3_405b, h2o_danube_1_8b, qwen3_0_6b, paligemma_3b,
            mamba2_780m, whisper_base]

ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# The paper's own (market) configuration.
LAISSEZCLOUD = laissezcloud.CONFIG


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def arch_names() -> List[str]:
    return list(ARCHS)


__all__ = ["ArchConfig", "LayerSpec", "ShapeConfig", "SHAPES", "ARCHS",
           "get_config", "arch_names", "applicable_shapes",
           "long_context_ok", "LAISSEZCLOUD"]
