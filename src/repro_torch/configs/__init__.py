"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

The port of ``repro.configs``: every architecture is a module in this
package exporting CONFIG with the exact published dimensions (source cited
in the module docstring), equal field for field to the JAX package's.
"""
from __future__ import annotations

from .base import ArchConfig, MoESpec, SSMSpec, reduced

from . import (
    gemma_7b,
    granite_20b,
    jamba_1_5_large,
    llama3_2_1b,
    mamba2_2_7b,
    minitron_8b,
    phi3_5_moe,
    qwen2_vl_2b,
    qwen3_moe_235b,
    whisper_base,
)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        granite_20b,
        qwen2_vl_2b,
        llama3_2_1b,
        qwen3_moe_235b,
        gemma_7b,
        minitron_8b,
        whisper_base,
        phi3_5_moe,
        mamba2_2_7b,
        jamba_1_5_large,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return list(ARCHS)


__all__ = [
    "ARCHS",
    "ArchConfig",
    "MoESpec",
    "SSMSpec",
    "get_config",
    "list_archs",
    "reduced",
]
