"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

The port of ``repro.configs``: every architecture is a module in this
package exporting CONFIG with the exact published dimensions (source cited
in the module docstring), equal field for field to the JAX package's.
"""
from __future__ import annotations

from .base import INPUT_SHAPES, ArchConfig, InputShape, MoESpec, SSMSpec, reduced

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


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def variant_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Arch variant actually run for a given input shape.

    ``long_500k`` on full-attention families switches to the sliding-window
    variant (window 4096, rolling KV cache); SSM/hybrid run natively."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid") and cfg.sliding_window is None:
        return cfg.replace(sliding_window=4096)
    return cfg


__all__ = [
    "ARCHS",
    "ArchConfig",
    "INPUT_SHAPES",
    "InputShape",
    "MoESpec",
    "SSMSpec",
    "get_config",
    "get_shape",
    "list_archs",
    "reduced",
    "variant_for_shape",
]
