"""The ``Experiment`` facade (``repro.api.experiment``).

An ``Experiment`` wires model / data source / sampler / scoring engine /
optimizer together from one ``RunConfig`` and runs the ``TrainLoop``:

    import repro_torch
    state, history = repro_torch.train("llama3.2-3b", preset="prod",
                                       overrides={"steps": 3})
    loss_ps, scores = repro_torch.score("llama3.2-3b", preset="prod")
    # Algorithm 1 inside the step, the τ gate switching IS on:
    state, history = repro_torch.train("lm-tiny", preset="paper_cifar",
                                       source="cls")

Everything runs on a CUDA device unless the caller passes ``device="cpu"``
(as the CPU tests do); with no GPU present the default raises. Meshes,
checkpoints, straggler handling and the elastic runtime are not ported
yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.config import (ConfigError, apply_overrides, build_run,
                                    get_preset, parse_cli, truthy)
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.is_train import StepSpec, build_step, train_state_init
from repro_torch.data.pipeline import (DataPlane, PipelineState,
                                       SyntheticCLS, SyntheticLM)
from repro_torch.models.lm import LM
from repro_torch.optim.api import get_optimizer
from repro_torch.sampler.schemes import make_sampler
from repro_torch.scoring.engine import ScoreEngine


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. A CUDA device that is not there raises:
    the port never drops to the CPU unless asked to."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and torch finds none; pass "
            "device='cpu' to run on the CPU explicitly")
    return device


def _make_source(run: RunConfig, kind):
    """"lm"/"cls" build the synthetic sources from the run config; source
    objects pass through."""
    if kind is None or kind == "lm":
        return SyntheticLM(run.model.vocab_size, run.shape.seq_len,
                           seed=run.seed)
    if kind == "cls":
        return SyntheticCLS(run.model.vocab_size, run.shape.seq_len,
                            seed=run.seed)
    if hasattr(kind, "gather"):
        return kind
    raise ConfigError(f"unknown data source {kind!r} (expected 'lm', 'cls', "
                      f"or a source object)")


def _resolve_run(cfg, preset=None, overrides=None) -> RunConfig:
    """str arch id | ModelConfig | RunConfig (+ preset + overrides) ->
    RunConfig."""
    if isinstance(cfg, RunConfig):
        if preset is not None:
            raise ConfigError("preset and a full RunConfig are exclusive")
        run = cfg
    elif isinstance(cfg, ModelConfig):
        run = get_preset(preset)(cfg) if preset else RunConfig(model=cfg)
    else:
        run = build_run(arch=cfg, preset=preset)
    return apply_overrides(run, overrides)


class Experiment:
    """Model + source + sampler + engine + loop, from one config."""

    def __init__(self, run_cfg, source=None, device=None, gate=None,
                 hooks=()):
        if run_cfg.ckpt_dir:
            raise ConfigError("checkpointing is not ported yet (ckpt_dir "
                              "must be unset)")
        self.run = run_cfg
        self.device = resolve_device(device)
        obs.configure(run_cfg.obs)
        gen = torch.Generator(device=self.device).manual_seed(run_cfg.seed)
        self.lm = LM(run_cfg.model, device=self.device, generator=gen)
        self.opt = get_optimizer(run_cfg.optim)
        self.source = _make_source(run_cfg, source)
        self.sampler = make_sampler(run_cfg, self.source,
                                    device=self.device)
        self.engine = ScoreEngine(self.lm, run_cfg)
        self.sampler.bind_engine(self.engine)
        self.default_hooks = list(hooks)
        # presample runs the paper's Algorithm 1 inside the step; the
        # score-memory and host/fused presample schemes hand the step b
        # host-chosen rows + the τ flag
        if self.sampler.uses_score_step:
            spec = StepSpec("host")
        else:
            spec = StepSpec("presample", gate=gate or (
                "cond" if run_cfg.imp.enabled else "never"))
        self.step_is_flagged = spec.flagged
        self.step_fn = build_step(self.lm, run_cfg, self.opt, spec)

    @classmethod
    def from_flags(cls, argv=None, **kw):
        """Build an ``Experiment`` from CLI flags: reserved ``--arch <id>``
        (required), ``--preset <name>``, ``--smoke``, ``--source lm|cls`` and
        ``--device <torch device>``; every other flag is a dotted
        ``RunConfig`` path (``--steps 3``, ``--shape.seq_len=1024``)."""
        import sys
        argv = list(sys.argv[1:]) if argv is None else list(argv)
        flags = parse_cli(argv)
        arch = flags.pop("arch", None)
        preset = flags.pop("preset", None)
        if truthy(flags.pop("smoke", False)):
            preset = preset or "smoke"
        source = flags.pop("source", "lm")
        device = flags.pop("device", None)
        if arch is None:
            raise ConfigError("--arch is required (one of "
                              "repro_torch.configs.ARCHS)")
        run = build_run(arch=arch, preset=preset, overrides=flags)
        return cls(run, source=source, device=device, **kw)

    def make_plane(self) -> DataPlane:
        return DataPlane(self.sampler, self.device)

    def resume_or_init(self):
        """(train state, pipeline state, first step): a fresh start, as
        checkpoint resume is not ported yet."""
        return (train_state_init(self.lm, self.opt, self.run.seed),
                PipelineState(), 0)

    def fit(self, steps=None, log_every=None, callback=None, hooks=()):
        """Train via the loop. Returns ``(state, history)``."""
        from repro_torch.api.hooks import (CallbackHook, LoggingHook,
                                           MetricsHistoryHook)
        from repro_torch.api.loop import TrainLoop
        hs = [MetricsHistoryHook()]
        if log_every:
            hs.append(LoggingHook(every=log_every))
        hs += list(self.default_hooks) + list(hooks)
        if callback is not None:
            hs.append(CallbackHook(callback))
        return TrainLoop(self, hs).run(steps)


def train(cfg="lm-tiny", *, preset=None, overrides=None, source=None,
          device=None, gate=None, steps=None, callback=None, hooks=(),
          log_every=None):
    """Train in one call. ``cfg`` is an arch id, a ``ModelConfig`` or a
    ``RunConfig``; ``preset`` names a registered cell (``smoke``,
    ``paper_cifar``, ``prod``); ``overrides`` is a dotted-path dict;
    ``source`` is ``"lm"``, ``"cls"`` or a source object; ``gate`` forces
    the presample step's branch (``"always"``, ``"never"``; default τ-gated
    when IS is enabled); ``callback(step, metrics)`` is called after each
    step. Returns ``(state, history)``."""
    run = _resolve_run(cfg, preset, overrides)
    exp = Experiment(run, source=source, device=device, gate=gate,
                     hooks=hooks)
    return exp.fit(steps=steps, callback=callback, log_every=log_every)


def score(cfg="lm-tiny", *, params=None, batch=None, gids=None, source=None,
          preset=None, overrides=None, mesh=None, device=None):
    """Score examples in one call: forward-only per-sample (loss, score)
    through the ``ScoreEngine``, no train step involved. Returns numpy
    (loss_ps, scores).

    ``batch`` wins if given; else ``gids`` are gathered from the source;
    else the source's first batch is scored. ``params=None`` scores a
    model freshly initialised from ``run.seed``; otherwise ``params`` is a
    ``{name: tensor}`` dict of the port's parameters (the train state's)."""
    if mesh is not None:
        raise NotImplementedError("sharded scoring (mesh=) is the "
                                  "distributed slice's work, not ported yet")
    run = _resolve_run(cfg, preset, overrides)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(run.seed)
    lm = LM(run.model, device=device, generator=gen)
    engine = ScoreEngine(lm, run)
    if batch is None:
        src = _make_source(run, source)
        if gids is not None:
            batch = src.gather(np.asarray(gids, np.int64))
        else:
            batch, _ = src.batch(PipelineState(), run.shape.global_batch)
    return engine.score_host(params, batch)
