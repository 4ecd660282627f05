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
feedback.

Checkpoints (``save_checkpoint``, driven by ``CheckpointHook``) drain
the pending feedback first, so the payload's score memory holds every
accepted step, and carry the plan cursor, the serialized run config and
the source spec in the manifest. A resume restarts the data plane at
the cursor: as in the reference, its first pool is scored against the
checkpoint's (post-update) params, where the straight run scored it
against the params one update earlier; plans agree while that pool's
selection does not turn on the difference (the τ gate closed, or the
same winners), and a run resumed at or past its final step trains and
writes nothing. Straggler retries and membership changes are not ported
yet, so ``attempts`` is always 1.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.data.pipeline import to_device

class TrainLoop:
    """Runs one training loop over an ``Experiment``'s composition."""

    def __init__(self, experiment, hooks=()):
        self.exp = experiment
        self.hooks = list(hooks)
        self.state = None
        self.pstate = None
        self.steps_target = 0
        self.steps_run = 0
        self.saved_step = None       # the step of the last checkpoint save
        self._pending = None         # (step, plan, scores) to observe
        self._h_step = obs.histogram("loop.step_s")
        self._c_steps = obs.counter("loop.steps")
        self._c_h2d = obs.counter("loop.h2d_bytes")

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

    def save_checkpoint(self, step: int, final: bool = False) -> None:
        """Snapshot {train, sampler} with the plan cursor, the serialized
        run config and the source spec in the manifest; the write runs on
        the checkpointer's thread (``final`` waits for it)."""
        exp = self.exp
        if exp.ckpt is None:
            return
        from repro_torch.api.config import to_dict
        self.drain_feedback()
        payload = exp.checkpoint_payload(self.state)
        exp.ckpt.save_async(step, payload,
                            meta={"pipeline": self.pstate.as_dict(),
                                  "run_config": to_dict(exp.run),
                                  "source": exp.source_spec})
        self.saved_step = step
        self.emit("checkpoint", step, payload)
        if final:
            exp.ckpt.wait()

    def run(self, steps=None):
        exp = self.exp
        steps = steps or exp.run.steps
        state, pstate, start = exp.resume_or_init()
        self.state, self.pstate = state, pstate
        self.steps_target, self.steps_run = steps, 0
        from repro_torch.api.hooks import MetricsHistoryHook
        hist = next((h for h in self.hooks
                     if isinstance(h, MetricsHistoryHook)), None)
        history = hist.history if hist is not None else []
        self.emit("loop_start", start, steps)
        if start >= steps:
            # resume at the final step: nothing to train, so no begin()
            # (no pool scored) and no checkpoint rewritten
            self.emit("loop_end", state, history)
            return state, history
        overlap = exp.run.imp.overlap_scoring
        plane = exp.make_plane()
        handle = plane.begin(pstate, start,
                             params=state["params"] if overlap else None)
        for i in range(start, steps):
            batch, plan, pstate_next = plane.finish(handle,
                                                    params=state["params"])
            # the train path's upload: the fused presample hands device
            # tensors through, so its count stays 0
            h2d = sum(np.asarray(v).nbytes for v in batch.values()
                      if not isinstance(v, torch.Tensor))
            if h2d:
                self._c_h2d.inc(h2d)
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
            metrics.update(step=i, dt=dt, attempts=1, dt_total=dt,
                           **exp.sampler.stats())
            self._h_step.observe(dt)
            self._c_steps.inc()
            self.steps_run += 1
            self.emit("step_end", i, metrics)
        self.drain_feedback()
        self.emit("loop_end", state, history)
        return state, history
