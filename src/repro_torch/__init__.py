"""repro_torch — the PyTorch/CUDA port of ``repro`` (Deep Learning with
Importance Sampling) for NVIDIA Hopper.

    import repro_torch
    state, history = repro_torch.train("llama3.2-3b", preset="prod",
                                       overrides={"steps": 3})
    loss_ps, scores = repro_torch.score("llama3.2-3b", preset="prod")
    out = repro_torch.serve("llama3.2-3b", batch=8, prompt_len=4096, gen=64)

The port mirrors ``repro``'s layout module by module and imports nothing
of it (nor of jax); the JAX package is the reference its tests hold it
against. Entry points run on a CUDA device unless given ``device="cpu"``.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "Experiment": "repro_torch.api.experiment",
    "train": "repro_torch.api.experiment",
    "score": "repro_torch.api.experiment",
    "serve": "repro_torch.api.serving",
    "TrainLoop": "repro_torch.api.loop",
    "build_run": "repro_torch.api.config",
    "apply_overrides": "repro_torch.api.config",
    "get_config": "repro_torch.configs",
    "ARCHS": "repro_torch.configs",
    "RunConfig": "repro_torch.configs.base",
    "ModelConfig": "repro_torch.configs.base",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
