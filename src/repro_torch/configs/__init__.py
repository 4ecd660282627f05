"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

The port carries the architectures its slices run; the others wait for
the slice that ports their block kinds.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ISConfig, ModelConfig, OptimConfig,
                                      RunConfig, SHAPES, SamplerConfig,
                                      Segment, ShapeConfig, reduced)

ARCHS = (
    "llama3.2-3b",
    "lm-tiny",
)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"arch {name!r} is not ported yet; have {ARCHS}")
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCHS}
