"""The training loop (``repro.api.loop``).

``TrainLoop`` keeps the operations whose ORDER defines training semantics
— the two-phase sampler handshake, step dispatch, score feedback into the
store, and bounded straggler retries — and reports through hooks:

    loop_start(start, steps)
    step_start(step, batch, meta)         after the batch materialises
    step_timed(step, attempt, dt)         every attempt; hooks VOTE retry
    retry(step, attempt, dt)              a vote passed; same batch re-runs
    step_end(step, metrics)               accepted step, metrics enriched
    scores_ready(step, meta, scores)      feedback drained into the store
    checkpoint(step, payload)             a checkpoint was written
    loop_end(state, history)

Events are isolated: a raising hook is counted (``loop.hook_errors``) and
reported once per hook class, and the run goes on. ``step_timed`` is the
exception: its return value is the retry vote, control flow, so it is not
guarded, and the vote goes through ``collectives.allreduce_any``.

Scoring order matches the reference's overlapped loop: batch k+1's pool
is scored against the params batch k's update starts from. The reference
dispatches step k and then launches that scoring beside it; PyTorch runs
eagerly and the optimizer updates the params in place, so this loop
scores batch k+1 first and then runs step k (same params, same plans,
no second copy of the weights). Score feedback is drained one step late,
as in the reference, so a store-backed scheme (``history``,
``selective``) plans step i+1 from a store that holds step i−1's
feedback. The data plane (``Experiment.make_plane``) pipelines the
pure-plan schemes on worker threads; ``run`` stops it in a ``finally``.

Retries. A passed vote drops the attempt and re-runs the same batch from
the state before it. The reference gets that state for free (its state
is immutable); here the optimizer updates the params and its moments in
place and the presample kind draws from a generator, so an attempt on
which a vote can pass starts with a copy of every tensor of the train
state and the generators' states (``_AttemptSnapshot``), and the retry
copies them back. A vote can pass when some hook that overrides
``on_step_timed`` says it may vote (``may_vote``, default yes; the real
straggler monitor only once its skip rung is reachable), on an attempt
that is not the last allowed, at one host. So a healthy run takes no
copy.

Checkpoints (``save_checkpoint``, driven by ``CheckpointHook``) drain
the pending feedback first and carry the plan cursor, the serialized run
config and the source spec in the manifest. A resume restarts the data
plane at the cursor: as in the reference, its first pool is scored
against the checkpoint's (post-update) params; a run resumed at or past
its final step trains and writes nothing.

A ``MembershipChange`` (the straggler escalation, or a gather that lost
a peer) leaves ``run`` with the plane stopped: the reference reshards
and replays the step, and the port has no elastic runtime yet.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.hooks import Hook
from repro_torch.data.pipeline import to_device
from repro_torch.distributed import collectives
from repro_torch.runtime import faults
from repro_torch.runtime.membership import MembershipChange


def _state_leaves(tree, tensors, gens, seen):
    """Every tensor and generator of a train state, once each."""
    if isinstance(tree, torch.Tensor):
        if id(tree) not in seen:
            seen.add(id(tree))
            tensors.append(tree)
    elif isinstance(tree, torch.Generator):
        gens.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _state_leaves(v, tensors, gens, seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _state_leaves(v, tensors, gens, seen)


class _AttemptSnapshot:
    """The train state before an attempt: a copy of every tensor and the
    generators' states. On a CUDA device the copy stays on the card when
    free memory holds twice its bytes (the step still needs room); else
    it goes to pinned host chunks of ``CHUNK`` bytes, allocated at the
    first host copy and kept until ``release`` (a power of two each, so
    the caching host allocator rounds none of them up). Copies are
    ordered on the current stream, before the step's kernels."""

    CHUNK = 1 << 30

    def __init__(self):
        self.where = None        # "device" | "host" | "cpu" of the last take
        self.taken = 0
        self.restored = 0
        self.take_s = []
        self.restore_s = []
        self._chunks = []
        self._copies = None
        self._tensors = None
        self._gens = None

    def take(self, state) -> None:
        t0 = time.perf_counter()
        tensors, gens = [], []
        _state_leaves(state, tensors, gens, set())
        self._tensors = tensors
        self._gens = [(g, g.get_state()) for g in gens]
        cuda = [t for t in tensors if t.is_cuda]
        nbytes = sum(t.numel() * t.element_size() for t in cuda)
        if not cuda:
            self.where = "cpu"
            self._copies = [t.detach().clone() for t in tensors]
        elif torch.cuda.mem_get_info(cuda[0].device)[0] >= 2 * nbytes:
            self.where = "device"
            self._copies = [t.detach().clone() for t in tensors]
        else:
            self.where = "host"
            self._copies = self._to_host(tensors, nbytes)
        self._sync(cuda)
        self.taken += 1
        self.take_s.append(time.perf_counter() - t0)

    def restore(self) -> None:
        """Copy the snapshot back into the live tensors, in place."""
        t0 = time.perf_counter()
        if self.where == "host":
            self._from_host()
        else:
            for t, c in zip(self._tensors, self._copies):
                t.detach().copy_(c)
        for g, s in self._gens:
            g.set_state(s)
        self._sync([t for t in self._tensors if t.is_cuda])
        self.restored += 1
        self.restore_s.append(time.perf_counter() - t0)

    def drop(self) -> None:
        """Forget the last take (the attempt was accepted)."""
        self._copies = self._tensors = self._gens = None

    def release(self) -> None:
        """Drop the pinned chunks, and the host allocator's cache of them."""
        self.drop()
        if self._chunks:
            self._chunks = []
            empty = getattr(torch._C, "_host_emptyCache", None)
            if empty is not None:    # not in every torch build
                empty()

    @staticmethod
    def _sync(cuda) -> None:
        if cuda:
            torch.cuda.synchronize(cuda[0].device)

    def _spans(self, off, n):
        """(chunk, lo, hi, a, b): bytes [a, b) of a leaf packed at byte
        ``off`` live in ``chunk[lo:hi]``."""
        pos, end = off, off + n
        while pos < end:
            c, lo = divmod(pos, self.CHUNK)
            k = min(self.CHUNK - lo, end - pos)
            yield self._chunks[c], lo, lo + k, pos - off, pos - off + k
            pos += k

    @staticmethod
    def _flat(t):
        """A CUDA tensor's bytes as a flat view (None for the rest)."""
        if not (t.is_cuda and t.is_contiguous()):
            return None
        return t.detach().reshape(-1).view(torch.uint8)

    def _to_host(self, tensors, nbytes):
        need = -(-nbytes // self.CHUNK)
        while len(self._chunks) < need:
            self._chunks.append(torch.empty(self.CHUNK, dtype=torch.uint8,
                                            pin_memory=True))
        kept, off = [], 0
        for t in tensors:
            f = self._flat(t)
            if f is None:
                kept.append(t.detach().to("cpu", copy=True))
                continue
            for chunk, lo, hi, a, b in self._spans(off, f.numel()):
                chunk[lo:hi].copy_(f[a:b], non_blocking=True)
            kept.append(None)
            off += f.numel()
        return kept

    def _from_host(self):
        off = 0
        for t, c in zip(self._tensors, self._copies):
            f = self._flat(t)
            if f is None:
                t.detach().copy_(c)
                continue
            for chunk, lo, hi, a, b in self._spans(off, f.numel()):
                f[a:b].copy_(chunk[lo:hi], non_blocking=True)
            off += f.numel()


class TrainLoop:
    """Runs one training loop over an ``Experiment``'s composition. The
    loop reads the experiment's parts (``step_fn``, ``sampler``,
    ``monitor``, ``ckpt``) at call time, so tests that swap them work."""

    def __init__(self, experiment, hooks=()):
        self.exp = experiment
        self.hooks = list(hooks)
        self.state = None
        self.pstate = None
        self.plane = None            # per-run DataPlane (made in run())
        self.steps_target = 0
        self.steps_run = 0
        self.saved_step = None       # the step of the last checkpoint save
        self.snapshot = _AttemptSnapshot()
        self._pending = None         # (step, plan, scores) to observe
        self._failed_hooks = set()   # hook classes already reported once
        self._sp_dispatch = obs.span("loop.dispatch")
        self._sp_drain = obs.span("loop.drain_feedback")
        self._sp_retry = obs.span("loop.retry")
        self._h_step = obs.histogram("loop.step_s")
        self._c_steps = obs.counter("loop.steps")
        self._c_retries = obs.counter("loop.retries")
        self._c_hook_errors = obs.counter("loop.hook_errors")
        self._c_h2d = obs.counter("loop.h2d_bytes")

    # -- events ---------------------------------------------------------------
    def emit(self, event, *args) -> None:
        """Dispatch an event to every hook, ISOLATED: a raising hook must
        not kill the run — the failure is counted (``loop.hook_errors``)
        and reported once per hook class. ``step_timed`` does not come
        through here (``_vote_retry``)."""
        for h in self.hooks:
            try:
                getattr(h, "on_" + event)(self, *args)
            except Exception as e:
                self._c_hook_errors.inc()
                cls = type(h)
                if cls not in self._failed_hooks:
                    self._failed_hooks.add(cls)
                    print(f"[repro_torch] hook {cls.__name__}.on_{event} "
                          f"raised {type(e).__name__}: {e} — hook errors "
                          f"are isolated; reporting this hook class once",
                          file=sys.stderr, flush=True)

    def _vote_retry(self, step, attempt, dt) -> bool:
        # a list, not a generator: every hook observes every attempt; not
        # isolated, since the votes are control flow
        local = any([h.on_step_timed(self, step, attempt, dt)
                     for h in self.hooks])
        # OR-reduced so every host takes the same branch (the identity at
        # one host)
        return collectives.allreduce_any(
            local, n_hosts=self.exp.sampler.n_hosts)

    def _vote_can_pass(self, attempt) -> bool:
        """Whether this attempt's vote can come out True, so that its
        state must be kept. At many hosts any host may vote (the vote is
        OR-reduced), so every attempt but the last allowed is armed."""
        if attempt >= self.exp.run.max_step_retries:
            return False
        if int(self.exp.sampler.n_hosts) > 1:
            return True
        for h in self.hooks:
            if getattr(type(h), "on_step_timed",
                       Hook.on_step_timed) is Hook.on_step_timed:
                continue
            may = getattr(h, "may_vote", None)
            if may is None or may(self):
                return True
        return False

    # -- score feedback (deferred, off the dispatch critical path) ------------
    def drain_feedback(self) -> None:
        """Flush the previous step's score feedback into the ScoreStore."""
        if self._pending is not None:
            step, plan, scores = self._pending
            self._pending = None
            with self._sp_drain:
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

    # -- the loop -------------------------------------------------------------
    def run(self, steps=None):
        exp = self.exp
        steps = steps or exp.run.steps
        state, pstate, start = exp.resume_or_init()
        self.state, self.pstate = state, pstate
        self.steps_target, self.steps_run = steps, 0
        self._pending = None
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
        plane = self.plane = exp.make_plane()
        try:
            return self._run_steps(plane, state, pstate, start, steps,
                                   overlap, history)
        finally:
            # also on exceptions: no worker outlives the run
            plane.stop()
            self.snapshot.release()

    def _finish_with_retry(self, plane, handle, state):
        """Pop the step's batch. On a pipelined plane that does not
        finalize, a surfaced gather error is transient by contract — the
        worker has already re-queued the plan — so re-pop within the retry
        budget. Fatal plan errors, passthrough and finalize planes, and
        membership changes propagate."""
        retriable = (getattr(plane, "pipelined", False)
                     and not getattr(plane, "finalize", False))
        budget = self.exp.run.max_step_retries
        for attempt in range(budget + 1):
            try:
                return plane.finish(handle, params=state["params"])
            except MembershipChange:
                raise
            except Exception:
                if (not retriable or attempt == budget
                        or getattr(plane, "fatal", None) is not None):
                    raise
                self._c_retries.inc()

    def _run_steps(self, plane, state, pstate, start, steps, overlap,
                   history):
        exp = self.exp
        run = exp.run
        handle = plane.begin(pstate, start,
                             params=state["params"] if overlap else None)
        for i in range(start, steps):
            faults.set_step(i)
            faults.die_if(i)
            batch, plan, pstate_next = self._finish_with_retry(plane, handle,
                                                               state)
            # the train path's upload: the fused presample and the plane's
            # device-put stage hand device tensors through (count 0)
            h2d = sum(np.asarray(v).nbytes for v in batch.values()
                      if not isinstance(v, torch.Tensor))
            if h2d:
                self._c_h2d.inc(h2d)
            batch = to_device(batch, exp.device)
            self.emit("step_start", i, batch, plan)
            launched_next = False
            dt_total = 0.0
            for attempt in range(run.max_step_retries + 1):
                armed = self._vote_can_pass(attempt)
                if armed:
                    self.snapshot.take(state)
                t0 = time.perf_counter()
                if not launched_next and i + 1 < steps:
                    # batch k+1's scoring, against the pre-update params
                    handle = plane.begin(
                        pstate_next, i + 1,
                        params=state["params"] if overlap else None)
                    launched_next = True
                prev_state = state
                with self._sp_dispatch:
                    if exp.step_is_flagged:
                        state, metrics = exp.step_fn(state, batch,
                                                     plan["is_flag"])
                    else:
                        state, metrics = exp.step_fn(state, batch)
                self.state = state
                self.drain_feedback()
                scores = metrics.pop("sample_scores", None)
                metrics = {k: float(v) for k, v in metrics.items()}
                # float() above waited for the device: dt is the wall time
                # of the next pool's scoring plus this step's update
                dt = time.perf_counter() - t0 + faults.slow_penalty(i)
                dt_total += dt
                if (not self._vote_retry(i, attempt, dt)
                        or attempt == run.max_step_retries):
                    # accepted — or retries exhausted, and the (merely
                    # slow) update is kept
                    break
                if not armed:
                    raise RuntimeError(
                        f"a retry vote passed at step {i}, attempt "
                        f"{attempt}, with no copy of the state before it: "
                        f"a hook's may_vote() said it would not vote")
                # drop this attempt (params, optimizer state, generator,
                # score feedback) and RETRY THE SAME BATCH
                self.snapshot.restore()
                state = prev_state
                self.state = state
                self._c_retries.inc()
                with self._sp_retry:
                    self.emit("retry", i, attempt, dt)
            self.snapshot.drop()
            if scores is not None:
                self._pending = (i, plan, scores)
            pstate = self.pstate = pstate_next
            metrics.update(step=i, dt=dt, attempts=attempt + 1,
                           dt_total=dt_total, **exp.sampler.stats())
            self._h_step.observe(dt)
            self._c_steps.inc()
            self.steps_run += 1
            self.emit("step_end", i, metrics)
        plane.stop()
        self.drain_feedback()
        self.emit("loop_end", state, history)
        return state, history
