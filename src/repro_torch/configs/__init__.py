"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

It holds the architectures the port serves; later slices add theirs."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import mamba2_780m, olmoe_1b_7b
from repro_torch.configs.base import ArchConfig, LayerSpec

ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG
                                for m in (olmoe_1b_7b, mamba2_780m)}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def arch_names() -> List[str]:
    return list(ARCHS)


__all__ = ["ArchConfig", "LayerSpec", "ARCHS", "get_config", "arch_names"]
