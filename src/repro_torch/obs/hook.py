"""``TelemetryHook`` — the flush pump from the registry to the sinks
(``repro.obs.hook``; the port runs one process, so ``proc`` is 0).

Instrumented code records into the process-local registry on the hot
path (cheap, no I/O); this hook drains it at ``step_end`` cadence
(every ``obs.flush_every`` accepted steps, plus ``loop_start`` /
``loop_end`` markers) through whatever ``Sink`` the ``ObsConfig``
names. I/O therefore never sits inside a step phase — the JSONL write
happens between steps, after the next step's work has been dispatched.

Record schema (the documented JSONL contract of ``repro/obs/schema.py``;
``tests/test_torch_obs.py`` checks the port's records against it)::

    {"event": "loop_start" | "step" | "loop_end",
     "step":  int,          # the step the flush observed (-1 pre-loop)
     "ts":    float,        # unix seconds at flush
     "proc":  int,          # the process index (0)
     "metrics": {           # registry snapshot + the step's metrics
        "<instrument>": int | float | {count,sum,min,max,avg,buckets},
        "step.<metric>": float,          # loss, dt, tau, ...
     }}
"""
from __future__ import annotations

import time

from repro_torch import obs
from repro_torch.api.hooks import Hook
from repro_torch.obs.sinks import make_sink


class TelemetryHook(Hook):
    """Flush the ``repro_torch.obs`` registry to a sink on step cadence.

    ``Experiment.fit`` installs one automatically when
    ``run.obs.enabled`` (after the ``VarianceGainHook``, so the health
    gauges are fresh at flush time); manual loops can construct one
    from any ``ObsConfig``.
    """

    def __init__(self, cfg, registry=None, sink=None):
        self.cfg = cfg
        self.registry = registry or obs.get_registry()
        self.registry.enable(True)
        self.proc = 0
        self.sink = sink if sink is not None else make_sink(cfg,
                                                            proc=self.proc)
        self.flush_every = max(int(cfg.flush_every), 1)

    def _record(self, event: str, step: int, step_metrics=None) -> dict:
        metrics = dict(self.registry.snapshot())
        for k, v in (step_metrics or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                metrics[f"step.{k}"] = float(v)
        return {"event": event, "step": int(step), "ts": time.time(),
                "proc": self.proc, "metrics": metrics}

    def on_loop_start(self, loop, start, steps):
        self.sink.write(self._record("loop_start", start - 1))

    def on_step_end(self, loop, step, metrics):
        if (step + 1) % self.flush_every == 0:
            self.sink.write(self._record("step", step, metrics))

    def on_loop_end(self, loop, state, history):
        last = history[-1] if history else {}
        self.sink.write(self._record("loop_end",
                                     loop.steps_target - 1, last))
        self.sink.close()
