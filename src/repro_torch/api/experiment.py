"""The ``Experiment`` facade (``repro.api.experiment``).

An ``Experiment`` wires model / data source / sampler / scoring engine /
optimizer / checkpointing together from one ``RunConfig`` and runs the
``TrainLoop``:

    import repro_torch
    state, history = repro_torch.train("llama3.2-3b", preset="prod",
                                       overrides={"steps": 3})
    loss_ps, scores = repro_torch.score("llama3.2-3b", preset="prod")
    # Algorithm 1 inside the step, the τ gate switching IS on:
    state, history = repro_torch.train("lm-tiny", preset="paper_cifar",
                                       source="cls")

Everything runs on a CUDA device unless the caller passes ``device="cpu"``
(as the CPU tests do); with no GPU present the default raises.

Checkpoints: with ``run.ckpt_dir`` set, ``fit`` resumes from the newest
committed checkpoint there (``resume_or_init``) and saves every
``run.ckpt_every`` steps and at the end (``CheckpointHook``), in the
reference's format, so a checkpoint of either package resumes in the
other. ``Experiment.from_checkpoint(dir)`` rebuilds the run from the
config in the checkpoint's manifest. With ``run.obs.enabled``, ``fit``
installs the IS-health hook first and the telemetry flush last.

Data: ``make_plane`` builds the depth-``run.data.prefetch_depth`` data
plane, with its device-put stage when ``run.data.device_put``. Faults:
``run.runtime.faults`` arms the deterministic fault schedule. Stragglers:
``monitor`` is the ``StragglerMonitor`` that ``fit``'s ``StragglerHook``
feeds (swap it for a scripted one in tests).

Not ported: meshes, the elastic runtime (a ``MembershipChange`` leaves
``fit``), and the resume onto another host count (the reference's
``_resume_resharded``; ``TopologyMismatch`` propagates).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.config import (ConfigError, apply_overrides, build_run,
                                    from_dict, get_preset, parse_cli, truthy)
from repro_torch.checkpoint import interop
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.is_train import StepSpec, build_step, train_state_init
from repro_torch.data.pipeline import (DataPlane, PipelineState,
                                       SyntheticCLS, SyntheticLM)
from repro_torch.models.lm import LM
from repro_torch.optim.api import get_optimizer
from repro_torch.runtime import faults
from repro_torch.runtime.straggler import StragglerMonitor
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
        self.run = run_cfg
        self.device = resolve_device(device)
        obs.configure(run_cfg.obs)
        faults.configure(run_cfg.runtime.faults, host_id=0)
        gen = torch.Generator(device=self.device).manual_seed(run_cfg.seed)
        self.lm = LM(run_cfg.model, device=self.device, generator=gen)
        self.opt = get_optimizer(run_cfg.optim)
        self.source = _make_source(run_cfg, source)
        # what the manifest records so from_checkpoint can rebuild the
        # data (a custom source object must be passed again)
        self.source_spec = source if isinstance(source, str) else (
            "lm" if source is None else "custom:" + type(source).__name__)
        self.ckpt = (Checkpointer(run_cfg.ckpt_dir, keep=run_cfg.keep_ckpts)
                     if run_cfg.ckpt_dir else None)
        self.sampler = make_sampler(run_cfg, self.source,
                                    device=self.device)
        self.engine = ScoreEngine(self.lm, run_cfg)
        self.sampler.bind_engine(self.engine)
        self.monitor = StragglerMonitor(run_cfg.step_deadline_factor)
        self.default_hooks = list(hooks)
        self.last_state = None       # the train state of the last fit()
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

    @classmethod
    def from_checkpoint(cls, ckpt_dir, source=None, device=None, **kw):
        """Rebuild the run serialized into a checkpoint's manifest
        (``run_config`` and ``source`` meta, written by every save of
        either package); ``fit()`` then resumes from that checkpoint."""
        meta = Checkpointer(ckpt_dir).meta()
        if "run_config" not in meta:
            raise ConfigError(f"checkpoint {ckpt_dir} predates the config "
                              f"manifest (no 'run_config' meta)")
        if source is None:
            spec = meta.get("source", "lm")
            if isinstance(spec, str) and spec.startswith("custom:"):
                raise ConfigError(
                    f"checkpoint {ckpt_dir} was trained with a custom data "
                    f"source ({spec[len('custom:'):]}) that cannot be "
                    f"rebuilt from the manifest — pass source= explicitly")
            source = spec
        run = dataclasses.replace(from_dict(meta["run_config"]),
                                  ckpt_dir=str(ckpt_dir))
        return cls(run, source=source, device=device, **kw)

    def make_plane(self) -> DataPlane:
        """A fresh per-run data plane over this experiment's sampler:
        pure-plan schemes (uniform, presample) get the depth-N pipelined
        plan → gather → device-put stages (``run.data``); store- and
        engine-coupled schemes pass through. The loop owns its lifetime."""
        return DataPlane(self.sampler, depth=self.run.data.prefetch_depth,
                         device_put=self.run.data.device_put,
                         device=self.device)

    def init_state(self):
        return (train_state_init(self.lm, self.opt, self.run.seed),
                PipelineState())

    def checkpoint_payload(self, state):
        """Checkpoint payload: the train state and the score memory."""
        return {"train": interop.train_payload(state),
                "sampler": self.sampler.state_dict()}

    def resume_or_init(self):
        """(train state, pipeline state, first step): from the newest
        committed checkpoint in ``run.ckpt_dir`` if there is one, else a
        fresh start."""
        state, pstate = self.init_state()
        if not (self.ckpt and self.ckpt.latest_step() is not None):
            return state, pstate, 0
        state, step = interop.load_train_state(self.ckpt, state,
                                               self.run.seed)
        try:
            # lenient: a checkpoint of another scheme still warms the
            # shared score store; scheme-specific extras keep their init
            samp, _ = self.ckpt.restore(
                {"sampler": self.sampler.state_dict()}, step=step,
                strict=False)
            self.sampler.load_state_dict(samp["sampler"])
        except (KeyError, ValueError):
            pass  # another dataset: the sampler starts cold
        meta = self.ckpt.meta(step)
        pstate = PipelineState.from_dict(meta.get("pipeline",
                                                  pstate.as_dict()))
        return state, pstate, step

    def fit(self, steps=None, log_every=None, callback=None, hooks=()):
        """Train via the loop. Returns ``(state, history)``."""
        from repro_torch.api.hooks import (CallbackHook, CheckpointHook,
                                           LoggingHook, MetricsHistoryHook,
                                           StragglerHook)
        from repro_torch.api.loop import TrainLoop
        hs = [MetricsHistoryHook()]
        if self.run.obs.enabled:
            # IS-health first, so every later hook sees its metrics
            from repro_torch.obs.health import VarianceGainHook
            hs.append(VarianceGainHook())
        if log_every:
            hs.append(LoggingHook(every=log_every))
        hs += list(self.default_hooks) + list(hooks)
        if callback is not None:
            hs.append(CallbackHook(callback))
        hs += [CheckpointHook(), StragglerHook()]
        if self.run.obs.enabled:
            # the flush last: its snapshot holds what every hook recorded
            from repro_torch.obs.hook import TelemetryHook
            hs.append(TelemetryHook(self.run.obs))
        state, history = TrainLoop(self, hs).run(steps)
        self.last_state = state
        return state, history

    def score(self, params, batch):
        """Forward-only per-sample (loss, score) through the engine;
        blocking, numpy."""
        return self.engine.score_host(params, batch)

    def serve(self, params=None, **kw):
        """Prefill + batched greedy decode with this experiment's model
        (``repro_torch.api.serving.serve``) on its device; ``params``
        defaults to the last trained params. Sharded serving (``mesh=``)
        is not ported yet."""
        from repro_torch.api.serving import serve as _serve
        if params is None and self.last_state is not None:
            params = self.last_state["params"]
        kw.setdefault("device", self.device)
        return _serve(self.run.model, params=params, **kw)


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
