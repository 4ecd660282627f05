"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

The port carries the architectures its slices run, in the reference's
order: every architecture whose blocks are global or sliding-window GQA,
in any input mode (tokens, frame embeddings, an image prefix), with a
dense or an MoE FFN. The others wait for the slice that ports their
block kinds (MLA, SSM, xLSTM).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ISConfig, ModelConfig, OptimConfig,
                                      RunConfig, SHAPES, SamplerConfig,
                                      Segment, ShapeConfig, reduced)

ARCHS = (
    "musicgen-medium",
    "internlm2-20b",
    "yi-34b",
    "llama3.2-3b",
    "gemma3-12b",
    "granite-moe-3b-a800m",
    "llava-next-34b",
    "lm-100m",
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
