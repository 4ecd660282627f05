"""``repro_torch.api`` — the port's public surface: ``Experiment``,
``train``, ``score``, ``serve``, the config layer (presets, dotted
overrides) and the loop."""
from repro_torch.api.config import (ConfigError, PRESETS, apply_overrides,
                                    build_run, get_preset, parse_cli,
                                    register_preset, truthy)
from repro_torch.api.experiment import (Experiment, resolve_device, score,
                                        train)
from repro_torch.api.hooks import (CallbackHook, Hook, LoggingHook,
                                   MetricsHistoryHook)
from repro_torch.api.loop import TrainLoop
from repro_torch.api.serving import serve

__all__ = [
    "Experiment", "train", "score", "serve", "resolve_device", "TrainLoop",
    "Hook", "CallbackHook", "LoggingHook", "MetricsHistoryHook",
    "ConfigError", "PRESETS", "apply_overrides", "build_run", "get_preset",
    "register_preset", "parse_cli", "truthy",
]
