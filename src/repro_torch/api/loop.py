"""The training loop (``repro.api.loop``, its core).

``TrainLoop`` keeps the operations whose ORDER defines training semantics
— the two-phase sampler handshake, step dispatch, score feedback into the
store — and reports through hooks (``step_start``, ``step_end``,
``scores_ready``, ``loop_start``/``loop_end``).

Scoring order matches the reference's overlapped loop: batch k+1's pool
is scored against the params batch k's update starts from. The reference
dispatches step k and then launches that scoring beside it; PyTorch runs
eagerly and the optimizer updates the params in place, so this loop
scores batch k+1 first and then runs step k (same params, same plans,
no second copy of the weights). Score feedback is drained one step late,
as in the reference, so a store-backed scheme (``history``,
``selective``) plans step i+1 from a store that holds step i−1's
feedback. Straggler retries, checkpoints and membership changes are not
ported yet.
"""
from __future__ import annotations

import time

from repro_torch import obs
from repro_torch.data.pipeline import to_device

class TrainLoop:
    """Runs one training loop over an ``Experiment``'s composition."""

    def __init__(self, experiment, hooks=()):
        self.exp = experiment
        self.hooks = list(hooks)
        self.state = None
        self.pstate = None
        self._pending = None         # (step, plan, scores) to observe
        self._h_step = obs.histogram("loop.step_s")
        self._c_steps = obs.counter("loop.steps")

    def emit(self, event, *args) -> None:
        for h in self.hooks:
            getattr(h, "on_" + event)(self, *args)

    def drain_feedback(self) -> None:
        """Flush the previous step's score feedback into the ScoreStore."""
        if self._pending is not None:
            step, plan, scores = self._pending
            self._pending = None
            with obs.span("loop.drain_feedback"):
                scores = scores.cpu().numpy()
                self.exp.sampler.observe(plan, scores)
            self.emit("scores_ready", step, plan, scores)

    def run(self, steps=None):
        exp = self.exp
        steps = steps or exp.run.steps
        state, pstate, start = exp.resume_or_init()
        self.state, self.pstate = state, pstate
        from repro_torch.api.hooks import MetricsHistoryHook
        hist = next((h for h in self.hooks
                     if isinstance(h, MetricsHistoryHook)), None)
        history = hist.history if hist is not None else []
        self.emit("loop_start", start, steps)
        overlap = exp.run.imp.overlap_scoring
        plane = exp.make_plane()
        handle = plane.begin(pstate, start,
                             params=state["params"] if overlap else None)
        for i in range(start, steps):
            batch, plan, pstate_next = plane.finish(handle,
                                                    params=state["params"])
            batch = to_device(batch, exp.device)
            self.emit("step_start", i, batch, plan)
            t0 = time.perf_counter()
            if i + 1 < steps:
                # batch k+1's scoring, against the pre-update params
                handle = plane.begin(
                    pstate_next, i + 1,
                    params=state["params"] if overlap else None)
            with obs.span("loop.dispatch"):
                if exp.step_is_flagged:
                    state, metrics = exp.step_fn(state, batch,
                                                 plan["is_flag"])
                else:
                    state, metrics = exp.step_fn(state, batch)
            self.state = state
            self.drain_feedback()
            scores = metrics.pop("sample_scores")
            metrics = {k: float(v) for k, v in metrics.items()}
            # float() above waited for the device: dt is the wall time of
            # the next pool's scoring plus this step's update
            dt = time.perf_counter() - t0
            self._pending = (i, plan, scores)
            pstate = self.pstate = pstate_next
            metrics.update(step=i, dt=dt, **exp.sampler.stats())
            self._h_step.observe(dt)
            self._c_steps.inc()
            self.emit("step_end", i, metrics)
        self.drain_feedback()
        self.emit("loop_end", state, history)
        return state, history
