"""Hooks for the training loop (``repro.api.hooks``). A hook subclasses
``Hook`` and overrides the events it cares about; the loop calls every
hook for every event, in order. Hooks are observers except
``on_step_timed``, the loop's one control point: returning True votes to
retry the same batch.

Shipped hooks: ``MetricsHistoryHook`` (the per-step metrics ``fit``
returns), ``LoggingHook`` (the step log line), ``CallbackHook`` (adapts
``callback(step, metrics)``), ``CheckpointHook`` (periodic and final
checkpoints) and ``StragglerHook`` (the straggler monitor's retry vote
and escalation). The IS-health and telemetry hooks live in
``repro_torch.obs``.

A hook that overrides ``on_step_timed`` may define ``may_vote(loop)``:
False promises that its next vote is False, so the loop need not copy
the train state before that attempt (the retry restores that copy).
"""
from __future__ import annotations

from repro_torch.runtime.membership import MembershipChange, MembershipEvent
from repro_torch.runtime.straggler import StragglerMonitor


class Hook:
    """Base hook: every event is a no-op. Override what you need."""

    def on_loop_start(self, loop, start, steps):
        pass

    def on_step_start(self, loop, step, batch, meta):
        pass

    def on_step_timed(self, loop, step, attempt, dt):
        """Called after EVERY attempt (retries included) with its wall
        time. Return True to vote for retrying the same batch."""
        return False

    def on_retry(self, loop, step, attempt, dt):
        pass

    def on_step_end(self, loop, step, metrics):
        pass

    def on_scores_ready(self, loop, step, meta, scores):
        pass

    def on_checkpoint(self, loop, step, payload):
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
        line = (f"step {step:5d} loss {metrics.get('loss', float('nan')):.4f}"
                f" tau {tau:.2f} is {active:.0f} "
                f"dt {metrics.get('dt', 0.0):.2f}s")
        if "variance_gain" in metrics:
            line += (f" vgain {metrics['variance_gain']:.2f}"
                     f" spd {metrics.get('speedup_est', 0.0):.2f}x")
        self.printer(line, flush=True)


class CallbackHook(Hook):
    """Adapts a ``callback(step, metrics)`` function onto the hook
    interface (``train(..., callback=...)``)."""

    def __init__(self, fn):
        self.fn = fn

    def on_step_end(self, loop, step, metrics):
        self.fn(step, metrics)


class CheckpointHook(Hook):
    """Periodic (every ``run.ckpt_every`` accepted steps) and final
    checkpoints through ``loop.save_checkpoint``. No-op without a
    checkpoint directory. Skips the final save when the loop trained zero
    steps (a resume at the final step must not rewrite the completed
    run's checkpoint), and when the periodic save already wrote the final
    step (the reference writes the same state twice there); it then only
    waits for that write."""

    def on_step_end(self, loop, step, metrics):
        if loop.exp.ckpt and (step + 1) % loop.exp.run.ckpt_every == 0:
            loop.save_checkpoint(step + 1)

    def on_loop_end(self, loop, state, history):
        if not (loop.exp.ckpt and loop.steps_run):
            return
        if loop.saved_step == loop.steps_target:
            loop.exp.ckpt.wait()
        else:
            loop.save_checkpoint(loop.steps_target, final=True)


class StragglerHook(Hook):
    """Straggler escalation as a hook: feed every attempt's wall time to
    the experiment's ``StragglerMonitor`` (read at call time, so a test can
    swap ``exp.monitor``) and vote to retry while it reports a skip.

    When the monitor reports ``escalate`` — the shrink floored AND the
    skip budget spent — the hook raises ``MembershipChange``. The port has
    no elastic runtime yet: the change leaves ``fit`` with the data plane
    stopped, where the reference resyncs and replays the step.
    ``.get`` keeps fake monitors without an ``escalate`` key working."""

    def may_vote(self, loop) -> bool:
        """Whether the next ``observe`` can return a skip: the real
        monitor skips only past its warm-up (5 observations) with the
        shrink at its floor and skips left. A scripted monitor can vote
        at any attempt."""
        mon = loop.exp.monitor
        if not isinstance(mon, StragglerMonitor):
            return True
        st = mon.state
        return (st.count >= 5 and st.b_scale <= mon.min_b_scale
                and st.skips < mon.max_skips)

    def on_step_timed(self, loop, step, attempt, dt):
        action = loop.exp.monitor.observe(dt)
        if action.get("escalate"):
            own = loop.exp.sampler.store.ownership
            raise MembershipChange(MembershipEvent(
                kind="straggler", step=step,
                members=tuple(getattr(own, "members", range(own.n_hosts))),
                reason=f"host over deadline for {attempt + 1} attempts "
                       f"with shrink floored and skip budget spent"))
        return bool(action["skip"])
