"""Declarative configs for ``repro_torch.api`` (``repro.api.config``).

* **Lossless serialization** — ``to_dict``/``from_dict`` (and the json
  twins) round-trip a ``RunConfig`` exactly, including the nested
  ``ModelConfig``. The training loop writes the serialized config into
  every checkpoint's manifest, so a run is rebuilt from its checkpoint
  alone (``Experiment.from_checkpoint``); the dict is the reference's, so
  a checkpoint's config crosses between the two packages.
* **Dotted CLI overrides** — ``parse_cli``/``apply_overrides`` turn
  ``--imp.presample_ratio=5 --shape.seq_len=1024 --steps 3`` into
  ``dataclasses.replace`` calls down the config tree. Every leaf field is
  addressable, values are coerced to the declared field type, and unknown
  keys are hard ``ConfigError``s.
* **Named presets** — ``smoke`` (the tiny one-device cell),
  ``paper_cifar`` (the paper's single-output classification cell, with
  the ``cls`` source), ``prod`` (the fused, survival-pruned training
  cell) and ``demo`` (the checkpointed CPU training demo).
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.configs import get_config
from repro_torch.configs.base import (DataConfig, FaultsConfig, ISConfig,
                                      MLAConfig, ModelConfig, MoEConfig,
                                      ObsConfig, OptimConfig, RunConfig,
                                      RuntimeConfig, SSMConfig,
                                      SamplerConfig, Segment, ShapeConfig,
                                      reduced)


class ConfigError(ValueError):
    """A config key/value the dataclass tree cannot represent (unknown
    field, nested path into a leaf, uncoercible value, unknown preset)."""


# ---------------------------------------------------------------------------
# RunConfig <-> dict/json (lossless)
# ---------------------------------------------------------------------------
# Nested dataclass-typed fields, per owner class (explicit, so decoding
# never depends on resolving the annotation strings).
_NESTED = {
    RunConfig: {"model": ModelConfig, "shape": ShapeConfig,
                "optim": OptimConfig, "imp": ISConfig,
                "sampler": SamplerConfig, "data": DataConfig,
                "obs": ObsConfig, "runtime": RuntimeConfig},
    ModelConfig: {"moe": MoEConfig, "mla": MLAConfig, "ssm": SSMConfig},
    RuntimeConfig: {"faults": FaultsConfig},
}


def _encode(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _encode(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return [_encode(v) for v in x]
    return x


def _decode(cls, d):
    if not isinstance(d, dict):
        raise ConfigError(f"expected a dict for {cls.__name__}, got {d!r}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ConfigError(f"unknown {cls.__name__} keys {sorted(unknown)}; "
                          f"valid: {sorted(names)}")
    nested = _NESTED.get(cls, {})
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in nested:
            kw[f.name] = _decode(nested[f.name], v)
        elif cls is ModelConfig and f.name == "segments":
            kw[f.name] = tuple(_decode(Segment, s) for s in v)
        elif cls is Segment and f.name == "pattern":
            kw[f.name] = tuple(v)
        else:
            kw[f.name] = v
    return cls(**kw)


def to_dict(run: RunConfig) -> dict:
    """``RunConfig`` -> plain JSON-able dict (lossless; see ``from_dict``)."""
    return _encode(run)


def from_dict(d: dict) -> RunConfig:
    """Inverse of ``to_dict``: ``from_dict(to_dict(run)) == run``."""
    return _decode(RunConfig, d)


def to_json(run: RunConfig) -> str:
    return json.dumps(to_dict(run), indent=2, sort_keys=True)


def from_json(s: str) -> RunConfig:
    return from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# dotted overrides (the auto-generated CLI)
# ---------------------------------------------------------------------------
_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off"}


def truthy(value) -> bool:
    """Interpret a CLI flag value (``parse_cli``'s bare-flag True or a
    string) as a bool."""
    return value is True or (isinstance(value, str) and value.lower() in _TRUE)


def _coerce(path, raw, ftype: str):
    """Coerce a CLI string to the declared dataclass field type (the field
    annotation string — base.py uses ``from __future__ import annotations``,
    so annotations are already their source text)."""
    t = ftype.strip()
    if t.startswith("Optional[") and t.endswith("]"):
        if raw is None or (isinstance(raw, str)
                           and raw.lower() in ("none", "null")):
            return None
        t = t[len("Optional["):-1]
    if isinstance(raw, bool):
        # includes parse_cli's bare-flag True: only bool fields may take it
        # (a forgotten value after e.g. --steps must not train 1 step)
        if t == "bool":
            return raw
        raise ConfigError(f"{path}: expected a {t} value, got a bare flag "
                          f"(did you forget --{path}=<value>?)")
    if not isinstance(raw, str):          # programmatic override: trust it
        return raw
    if t == "bool":
        low = raw.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ConfigError(f"{path}: expected a bool, got {raw!r}")
    if t == "int":
        return int(raw)
    if t == "float":
        return float(raw)
    if t == "str":
        return raw
    raise ConfigError(f"{path}: fields of type {t!r} cannot be set from a "
                      f"command-line string")


def _set_path(obj, rel_path, value, full_path):
    head, _, rest = rel_path.partition(".")
    fields = {f.name: f for f in dataclasses.fields(obj)}
    if head not in fields:
        raise ConfigError(
            f"unknown config key {full_path!r} ({head!r} is not a field of "
            f"{type(obj).__name__}; valid: {sorted(fields)})")
    cur = getattr(obj, head)
    if rest:
        if not dataclasses.is_dataclass(cur):
            raise ConfigError(f"{full_path!r}: {head!r} is a leaf field, "
                              f"not a nested config")
        return dataclasses.replace(
            obj, **{head: _set_path(cur, rest, value, full_path)})
    if dataclasses.is_dataclass(cur):
        raise ConfigError(f"{full_path!r} names a nested config; set one of "
                          f"its fields instead (e.g. {full_path}.<field>)")
    return dataclasses.replace(
        obj, **{head: _coerce(full_path, value, fields[head].type)})


def apply_overrides(run: RunConfig, overrides: dict) -> RunConfig:
    """Apply ``{"imp.presample_ratio": "5", "steps": 200, ...}`` onto a
    ``RunConfig``. Unknown keys are hard errors; string values are coerced
    to the declared field types."""
    for key, value in (overrides or {}).items():
        run = _set_path(run, key, value, key)
    return run


def parse_cli(argv) -> dict:
    """Tokenize ``--key=value`` / ``--key value`` / bare ``--flag`` (→True)
    into an ordered dict. Dashes within a key segment normalise to
    underscores (``--imp.presample-ratio`` == ``--imp.presample_ratio``);
    dots are path separators. No schema knowledge here — unknown keys are
    rejected later by ``apply_overrides`` (or the caller's reserved-flag
    handling), so the error can name the dataclass involved."""
    out = {}
    toks = list(argv)
    i = 0
    while i < len(toks):
        tok = toks[i]
        if not tok.startswith("--"):
            raise ConfigError(f"unexpected argument {tok!r} (flags are "
                              f"--key=value, --key value, or bare --flag)")
        tok = tok[2:]
        if "=" in tok:
            key, value = tok.split("=", 1)
            i += 1
        elif i + 1 < len(toks) and not toks[i + 1].startswith("--"):
            key, value = tok, toks[i + 1]
            i += 2
        else:
            key, value = tok, True
            i += 1
        out[key.replace("-", "_")] = value
    return out


# ---------------------------------------------------------------------------
# preset registry
# ---------------------------------------------------------------------------
PRESETS: dict = {}


def register_preset(name: str, doc: str = ""):
    """Register ``fn(model_cfg: ModelConfig) -> RunConfig`` as a named
    run-level cell, selectable with ``--preset <name>``."""
    def deco(fn):
        fn.preset_doc = doc
        PRESETS[name] = fn
        return fn
    return deco


def get_preset(name: str):
    if name not in PRESETS:
        raise ConfigError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]


def list_presets() -> list:
    return sorted(PRESETS)


@register_preset("smoke", "tiny shape, reduced model, 20 steps, 1 device (CI)")
def _smoke(model: ModelConfig) -> RunConfig:
    return RunConfig(
        model=reduced(model, repeats=1),
        shape=ShapeConfig("smoke", seq_len=32, global_batch=8, kind="train"),
        optim=OptimConfig(name="adamw", lr=1e-3, weight_decay=0.0),
        imp=ISConfig(enabled=True, presample_ratio=3, tau_th=1.2),
        steps=20, remat=False)


@register_preset("paper_cifar",
                 "the paper's single-output classification cell "
                 "(CPU-scale; pair with the SyntheticCLS source)")
def _paper_cifar(model: ModelConfig) -> RunConfig:
    return RunConfig(
        model=model,
        shape=ShapeConfig("cls", seq_len=16, global_batch=16, kind="train"),
        optim=OptimConfig(name="adamw", lr=2e-3, weight_decay=0.0),
        imp=ISConfig(enabled=True, presample_ratio=3, tau_th=1.3),
        steps=120, remat=False)


@register_preset("prod", "pod-scale training cell: train_4k shape, adamw, "
                         "1000 steps, ckpt every 100, telemetry on")
def _prod(model: ModelConfig) -> RunConfig:
    return RunConfig(
        model=model,
        optim=OptimConfig(name="adamw", lr=3e-4),
        # fused presample: the pool stays on the device, only the (B,)
        # scores and the (b,) selection cross — same plans as the host path;
        # survival-pruned scoring: rows that already lost the step's race
        # stop being scored mid-pool (conservative — plans are unchanged
        # within the mode; kernels.prune.* counters carry the receipt)
        imp=ISConfig(enabled=True, presample_ratio=3,
                     presample_impl="fused", score_prune="conservative"),
        # production runs are observable by default: JSONL telemetry
        # (loop spans, data-plane stages, store counters, IS-health
        # gauges) every 10 accepted steps
        obs=ObsConfig(enabled=True),
        steps=1000, ckpt_every=100)


@register_preset("demo", "CPU training demo: seq 256, b=16, checkpointed")
def _demo(model: ModelConfig) -> RunConfig:
    return RunConfig(
        model=model,
        shape=ShapeConfig("train", seq_len=256, global_batch=16, kind="train"),
        optim=OptimConfig(name="adamw", lr=3e-4, weight_decay=0.01),
        imp=ISConfig(enabled=True, presample_ratio=3),
        steps=300, remat=True,
        ckpt_dir="/tmp/repro_ckpt", ckpt_every=50)


def build_run(arch=None, preset=None, overrides=None, model=None) -> RunConfig:
    """The declarative entry point: architecture id (+ optional preset)
    + dotted overrides -> ``RunConfig``."""
    if model is None:
        if arch is None:
            raise ConfigError("need an --arch (or an explicit model config)")
        model = get_config(arch)
    run = get_preset(preset)(model) if preset else RunConfig(model=model)
    return apply_overrides(run, overrides)
