"""``repro_torch.api`` — the port's public surface: ``Experiment``,
``train``, ``score``, ``serve``, the config layer (presets, dotted
overrides, the lossless serialization) and the loop with its hooks."""
from repro_torch.api.config import (ConfigError, PRESETS, apply_overrides,
                                    build_run, from_dict, from_json,
                                    get_preset, list_presets, parse_cli,
                                    register_preset, to_dict, to_json,
                                    truthy)
from repro_torch.api.experiment import (Experiment, resolve_device, score,
                                        train)
from repro_torch.api.hooks import (CallbackHook, CheckpointHook, Hook,
                                   LoggingHook, MetricsHistoryHook,
                                   StragglerHook)
from repro_torch.api.loop import TrainLoop
from repro_torch.api.serving import serve

__all__ = [
    "Experiment", "train", "score", "serve", "resolve_device", "TrainLoop",
    "Hook", "CallbackHook", "CheckpointHook", "LoggingHook",
    "MetricsHistoryHook", "StragglerHook", "ConfigError", "PRESETS",
    "apply_overrides", "build_run", "get_preset", "list_presets",
    "register_preset", "parse_cli", "truthy", "to_dict", "from_dict",
    "to_json", "from_json",
]
