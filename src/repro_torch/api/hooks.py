"""Hooks for the training loop (``repro.api.hooks``, the observers the
slice needs). A hook subclasses ``Hook`` and overrides the events it
cares about; the loop calls every hook for every event, in order."""
from __future__ import annotations


class Hook:
    """Base hook: every event is a no-op. Override what you need."""

    def on_loop_start(self, loop, start, steps):
        pass

    def on_step_start(self, loop, step, batch, meta):
        pass

    def on_step_end(self, loop, step, metrics):
        pass

    def on_scores_ready(self, loop, step, meta, scores):
        pass

    def on_loop_end(self, loop, state, history):
        pass


class MetricsHistoryHook(Hook):
    """Collects the per-step metrics dicts (the loop's return value)."""

    def __init__(self):
        self.history = []

    def on_step_end(self, loop, step, metrics):
        self.history.append(metrics)


class LoggingHook(Hook):
    """Step log line every ``every`` steps."""

    def __init__(self, every=10, printer=print):
        self.every = max(int(every), 1)
        self.printer = printer

    def on_step_end(self, loop, step, metrics):
        if step % self.every:
            return
        tau = metrics.get("tau", metrics.get("presample_tau", 0.0))
        active = metrics.get("is_active", metrics.get("sampler_active", 0.0))
        self.printer(f"step {step:5d} loss {metrics.get('loss', float('nan')):.4f}"
                     f" tau {tau:.2f} is {active:.0f} "
                     f"dt {metrics.get('dt', 0.0):.2f}s", flush=True)


class CallbackHook(Hook):
    """Adapts a ``callback(step, metrics)`` function onto the hook
    interface (``train(..., callback=...)``)."""

    def __init__(self, fn):
        self.fn = fn

    def on_step_end(self, loop, step, metrics):
        self.fn(step, metrics)
