"""Architecture registry: one module per assigned architecture.

Each module exposes ``CONFIG`` (the exact published dims) and ``SMOKE`` (a reduced
same-family config for CPU tests).  ``get_config(name, smoke=...)`` is the single
lookup the launcher / tests / dry-run use; ``ARCHS`` lists ids for ``--arch``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, SHAPES, ShapeConfig

ARCHS: tuple[str, ...] = (
    "pixtral-12b",
    "llama3-405b",
    "granite-34b",
    "qwen2.5-14b",
    "qwen1.5-110b",
    "deepseek-v2-236b",
    "qwen3-moe-235b-a22b",
    "musicgen-large",
    "xlstm-350m",
    "hymba-1.5b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}

# Archs with sub-quadratic token mixing: the only ones that run long_500k.
SUBQUADRATIC: tuple[str, ...] = ("xlstm-350m", "hymba-1.5b")


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


def shape_applicable(arch: str, shape: str | ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (skip for full-attention archs)."""
    shape_name = shape if isinstance(shape, str) else shape.name
    if shape_name == "long_500k":
        return arch in SUBQUADRATIC
    return True


def cells(include_skipped: bool = False):
    """All assigned (arch, shape) cells; 40 total, 32 runnable."""
    for arch in ARCHS:
        for shape in SHAPES.values():
            if include_skipped or shape_applicable(arch, shape):
                yield arch, shape


__all__ = ["ARCHS", "SUBQUADRATIC", "get_config", "shape_applicable", "cells",
           "SHAPES"]
