"""Deterministic, resumable data pipeline (``repro.data.pipeline``).

* ``PipelineState`` — the (epoch, cursor) iterator state; under the
  selection plane it is also the PLAN CURSOR, and as ``as_dict()`` it
  rides every checkpoint's manifest (``meta["pipeline"]``), so a resume
  re-plans the same sequence.
* ``DataSource`` — the index math every source shares; ``SyntheticLM`` —
  seeded on-the-fly token streams with structured difficulty;
  ``SyntheticCLS`` — the paper's single-output classification setting;
  ``MemmapLM`` — a pre-tokenised corpus (one flat int32 ``.npy``) with a
  seeded shuffle per epoch. Sources are numpy, so their batches are
  bitwise the reference's.
* ``DataPlane`` — the depth-N pipelined plane: plan → gather → device-put
  on worker threads, bounded by ``depth`` credits, so batch assembly and
  the host-to-card copy overlap the update step and the pool's scoring.
  Schemes whose plans read the score memory or the engine pass through to
  the sampler's own two-phase ``begin``/``finish``.
* ``Prefetcher`` — the deprecated depth-1 wrapper.

On a CUDA device the device-put stage copies from pinned host memory on
a stream of its own and records an event there; the consuming thread
makes its current stream wait for that event and marks every tensor as
used on that stream (``record_stream``) before it hands the batch on, so
a step never reads a batch before it lands and the caching allocator
never reuses its memory while a step still reads it.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.runtime import faults
from repro_torch.runtime.membership import MembershipChange


@dataclasses.dataclass
class PipelineState:
    epoch: int = 0
    cursor: int = 0

    def as_dict(self):
        return {"epoch": self.epoch, "cursor": self.cursor}

    @classmethod
    def from_dict(cls, d):
        return cls(int(d["epoch"]), int(d["cursor"]))

    def advance(self, consumed: int, n_examples: int) -> "PipelineState":
        """Consume ``consumed`` global examples; roll the epoch at the end."""
        cursor = self.cursor + consumed
        if cursor >= n_examples:
            return PipelineState(self.epoch + 1, 0)
        return PipelineState(self.epoch, cursor)


class DataSource:
    """Index-addressable data source base (one host)."""

    def __init__(self, n_examples):
        self.n = int(n_examples)

    def gather(self, indices, epoch: int = 0) -> dict:
        """Materialise arbitrary examples by global id."""
        raise NotImplementedError

    def global_indices(self, state: PipelineState, batch_size: int):
        """Global example ids of all rows of the next batch."""
        return (state.cursor + np.arange(batch_size, dtype=np.int64)) % self.n

    def batch(self, state: PipelineState, batch_size: int):
        """The next global batch and the state after it (at one host the
        local indices are the global ones)."""
        batch = self.gather(self.global_indices(state, batch_size),
                            epoch=state.epoch)
        return batch, state.advance(batch_size, self.n)


class SyntheticLM(DataSource):
    """Deterministic synthetic LM data with heterogeneous difficulty.

    Each example i of epoch e is generated from PRNG(seed, e, i):
    * easy examples (frac_easy): a repeated short motif — predictable.
    * hard examples: iid uniform tokens — irreducible entropy.
    """

    def __init__(self, vocab_size, seq_len, n_examples=1 << 16, seed=0,
                 frac_easy=0.7):
        super().__init__(n_examples)
        self.vocab = int(vocab_size)
        self.seq = int(seq_len)
        self.seed = seed
        self.frac_easy = frac_easy
        r = np.random.default_rng(np.random.SeedSequence([self.seed, 777]))
        self._motifs = r.integers(0, self.vocab, size=(4, 8))

    def _example(self, rng: np.random.Generator, idx: int):
        easy = (idx % 1000) / 1000.0 < self.frac_easy
        if easy:
            motif = self._motifs[rng.integers(0, 4)]
            phase = int(rng.integers(0, 8))
            toks = np.tile(motif, self.seq // 8 + 2)[phase: phase + self.seq]
        else:
            toks = rng.integers(0, self.vocab, size=(self.seq,))
        return toks.astype(np.int32)

    def gather(self, indices, epoch: int = 0):
        indices = np.asarray(indices, np.int64)
        toks = np.empty((len(indices), self.seq + 1), np.int32)
        for j, idx in enumerate(indices):
            idx = int(idx) % self.n
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, idx]))
            ex = self._example(rng, idx)
            toks[j] = np.concatenate([ex, ex[:1]])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class SyntheticCLS(DataSource):
    """Sequence-classification data in the paper's single-output setting:
    the loss sits on the LAST position only (labels elsewhere are -1), so
    the per-sample score is exactly the paper's ‖softmax(z) − 1_y‖₂.

    Each example: a class-template token sequence with per-token
    corruption; the corruption rate varies per example (0 → trivially
    easy, 0.55 → hard), the heterogeneous difficulty IS exploits.
    """

    def __init__(self, vocab_size, seq_len, n_classes=8, n_examples=1 << 14,
                 seed=0):
        super().__init__(n_examples)
        self.vocab = int(vocab_size)
        self.seq = int(seq_len)
        self.n_classes = n_classes
        self.seed = seed
        r = np.random.default_rng(np.random.SeedSequence([seed, 555]))
        # class templates live in token range [n_classes, vocab)
        self.templates = r.integers(n_classes, self.vocab,
                                    size=(n_classes, seq_len))

    def _example(self, rng, idx):
        c = int(rng.integers(0, self.n_classes))
        corrupt = float(rng.uniform(0.0, 0.55)) * (idx % 3 != 0)  # 1/3 clean
        toks = self.templates[c].copy()
        mask = rng.uniform(size=self.seq) < corrupt
        toks[mask] = rng.integers(self.n_classes, self.vocab,
                                  size=int(mask.sum()))
        labels = np.full((self.seq,), -1, np.int64)
        labels[-1] = c                          # single-output CE (paper)
        return toks.astype(np.int32), labels.astype(np.int32)

    def gather(self, indices, epoch: int = 0):
        indices = np.asarray(indices, np.int64)
        toks = np.empty((len(indices), self.seq), np.int32)
        labels = np.empty((len(indices), self.seq), np.int32)
        for j, idx in enumerate(indices):
            idx = int(idx) % self.n
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, idx]))
            toks[j], labels[j] = self._example(rng, idx)
        return {"tokens": toks, "labels": labels}




class MemmapLM(DataSource):
    """Pre-tokenised corpus (one flat int32 .npy) with seeded epoch shuffle."""

    def __init__(self, path, seq_len, seed=0):
        self.data = np.load(path, mmap_mode="r")
        self.seq = int(seq_len)
        super().__init__((len(self.data) - 1) // self.seq)
        self.seed = seed

    def _perm(self, epoch):
        # size-1 memo: the sampler derives indices 2-3x per step and a full
        # O(n) reshuffle per call would dominate the host critical path
        cached = getattr(self, "_perm_cache", None)
        if cached is None or cached[0] != epoch:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch]))
            self._perm_cache = (epoch, rng.permutation(self.n))
        return self._perm_cache[1]

    def global_indices(self, state: PipelineState, batch_size: int):
        """Global example ids (UNpermuted corpus slots, stable across
        epochs — what a persistent score memory keys on) of the next
        batch's rows."""
        perm = self._perm(state.epoch)
        pos = (state.cursor + np.arange(batch_size, dtype=np.int64)) % self.n
        return perm[pos].astype(np.int64)

    def gather(self, indices, epoch: int = 0):
        indices = np.asarray(indices, np.int64)
        toks = np.empty((len(indices), self.seq + 1), np.int32)
        for j, idx in enumerate(indices):
            o = (int(idx) % self.n) * self.seq
            toks[j] = self.data[o: o + self.seq + 1]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def to_device(batch: dict, device) -> dict:
    """Every value as a tensor on ``device`` (tensors already there pass
    through)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _on(t, device) -> bool:
    return isinstance(t, torch.Tensor) and t.device == device


# ---------------------------------------------------------------------------
# the pipelined data plane
# ---------------------------------------------------------------------------
class DataPlane:
    """Depth-N pipelined data plane over a plan-emitting sampler.

    Three stages on worker threads — **plan** (``sampler.plan``: pure index
    math), **gather** (``sampler.assembler.assemble``: the host-side
    materialisation), **device-put** (the host-to-card copy) — connected
    by queues. A credit semaphore bounds the pipeline to ``depth`` batches
    in flight, so planning runs at most ``depth`` steps ahead of
    consumption and memory stays bounded.

    Only samplers whose plans are pure functions of the pipeline cursor
    (``sampler.plan_is_pure``) are pipelined; for the others the plane is
    a passthrough over the sampler's own ``begin``/``finish``. A sampler
    that carves its selection out of a pre-gathered candidate pool
    (``begin_finalize``, the fused presample) gets the pool from the
    plane at ``begin`` and finalises it itself (the finalize protocol).

    The plane's durable state is the PLAN CURSOR (``state_dict``): plans
    are pure, so a resume re-plans the identical sequence.

    Failures: a gather error is surfaced on the consuming ``finish``/
    ``next`` call and the same plan is retried in the background (one
    credit per consumed batch); a plan error is fatal (``fatal``).

    Every wait is bounded: a worker polls its queue and the stop flag
    every ``POLL_S``, ``next`` raises ``TimeoutError`` after ``TIMEOUT_S``
    without a batch (and at once when the plane was stopped), and
    ``stop`` joins each worker for at most ``JOIN_S``.
    """

    POLL_S = 0.1
    TIMEOUT_S = 600.0    # far above any gather: a plane that stalls raises
    JOIN_S = 30.0

    def __init__(self, sampler, depth: int = 2, device_put=False,
                 sync_launch=False, device=None):
        self.sampler = sampler
        self.depth = max(int(depth), 1)
        self.pipelined = bool(getattr(sampler, "plan_is_pure", False))
        self.finalize = (self.pipelined and
                         callable(getattr(sampler, "begin_finalize", None)))
        device = torch.device(device if device is not None else
                              (getattr(sampler, "device", None) or "cpu"))
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._device_put = bool(device_put)
        # sync_launch: ``next`` returns only once the FOLLOWING gather has
        # entered the source (the old Prefetcher's launch-then-return
        # contract, which its error-injection semantics rely on)
        self._sync_launch = bool(sync_launch)
        self._copy_stream = None   # the device-put stage's CUDA stream
        self._started = False
        self._stop = threading.Event()
        self._credits = threading.Semaphore(0)
        self._gather_cv = threading.Condition()
        self._gathers_started = 0
        self._pops = 0
        self._plan_q = queue.Queue()
        self._dev_q = queue.Queue()
        self._out_q = queue.Queue()
        self._threads = []
        self._cursor0 = None       # (PipelineState, step) given to start()
        self._consumed = None      # (PipelineState, next step) after pops
        self._fatal = None         # terminal plan-stage error
        # stage telemetry (inert unless repro_torch.obs is enabled); spans
        # keep per-thread start stacks, so one handle serves all workers
        self._sp_plan = obs.span("plane.plan")
        self._sp_gather = obs.span("plane.gather")
        self._sp_device_put = obs.span("plane.device_put")
        self._sp_wait = obs.span("plane.next_wait")
        self._g_depth = obs.gauge("plane.queue_depth")
        self._c_stalls = obs.counter("plane.credit_stalls")
        self._c_batches = obs.counter("plane.batches")
        self._c_put_skipped = obs.counter("plane.device_put_skipped")
        self._c_put_bytes = obs.counter("plane.device_put_bytes")

    # -- the loop-facing two-phase handshake ----------------------------------
    def begin(self, pstate, step: int, params=None):
        if not self.pipelined:
            return self.sampler.begin(pstate, step, params=params)
        if not self._started:
            self.start(pstate, step)
        if self.finalize:
            # pop the pre-gathered candidate pool NOW so the sampler can
            # dispatch its scoring pass
            pool, cplan, cursor = self.next()
            return self.sampler.begin_finalize(cplan, pool, cursor,
                                               params=params)
        return {"step": step}

    def finish(self, handle, params=None):
        if not self.pipelined:
            return self.sampler.finish(handle, params=params)
        if self.finalize:
            batch, plan, cursor = self.sampler.finish_finalize(
                handle, params=params)
            if self._device_put:
                # the finalized batch skips the worker's stage; run it
                # through the same gate so an on-device batch records its
                # skip (and a host fallback batch is still transferred)
                with self._sp_device_put:
                    batch = self._adopt(*self._put_batch(batch))
        else:
            batch, plan, cursor = self.next()
        self.sampler.notify_consumed(plan)
        return batch, plan, cursor

    # -- pipelined core -------------------------------------------------------
    def start(self, pstate, step: int) -> None:
        if self._started:
            raise RuntimeError("DataPlane already started")
        self._started = True
        self._cursor0 = (pstate, int(step))
        self._consumed = (pstate, int(step))
        for _ in range(self.depth):
            self._credits.release()
        stages = [self._plan_worker, self._gather_worker]
        if self._device_put:
            stages.append(self._device_worker)
        for fn in stages:
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"DataPlane.{fn.__name__[1:]}")
            t.start()
            self._threads.append(t)

    def _pop(self):
        """The next output item, polling so a stopped plane or a silent
        pipeline raises instead of blocking for ever."""
        waited = 0.0
        while True:
            try:
                return self._out_q.get(timeout=self.POLL_S)
            except queue.Empty:
                waited += self.POLL_S
            if self._stop.is_set():
                raise RuntimeError("DataPlane stopped")
            if waited >= self.TIMEOUT_S:
                raise TimeoutError(f"DataPlane produced no batch in "
                                   f"{self.TIMEOUT_S:g} s")

    def next(self):
        """Pop the next (batch, plan, cursor') — blocking. Raises the
        worker's error (the failed plan is retried in the background)."""
        if not self._started:
            raise RuntimeError("DataPlane not started (call start/begin)")
        if self._fatal is not None:
            # the plan worker is gone; blocking on the queue would hang
            raise self._fatal
        self._g_depth.set(self._out_q.qsize())
        with self._sp_wait:          # consumer starvation = pipeline behind
            tag, *rest = self._pop()
        if tag == "fatal":
            self._fatal = rest[0]
            raise self._fatal
        if tag == "err":
            raise rest[0]
        batch, plan, cursor, ready = rest
        batch = self._adopt(batch, ready)
        self._consumed = (cursor, int(getattr(plan, "step", -1)) + 1)
        self._pops += 1
        self._c_batches.inc()
        self._credits.release()      # one more plan may enter the pipeline
        if self._sync_launch:
            # block until the gather AFTER the ones consumed has begun, so
            # a caller mutating the source next affects batch k+2, never
            # the in-flight k+1 (Prefetcher semantics)
            with self._gather_cv:
                self._gather_cv.wait_for(
                    lambda: (self._gathers_started > self._pops
                             or self._stop.is_set()), timeout=5.0)
        return batch, plan, cursor

    def stop(self) -> None:
        self._stop.set()
        self._credits.release()      # unblock a waiting plan worker
        for t in self._threads:
            t.join(timeout=self.JOIN_S)
        alive = [t.name for t in self._threads if t.is_alive()]
        self._threads = []
        if alive:
            # not raised: stop() runs in the loop's ``finally``, where an
            # error would hide the one that is propagating
            warnings.warn(f"DataPlane workers {alive} did not stop within "
                          f"{self.JOIN_S:g} s", RuntimeWarning, stacklevel=2)

    @property
    def fatal(self):
        """The terminal plan-stage error, if any. Surfaced errors with no
        fatal set are transient gather errors by contract (the worker has
        already re-queued the plan) — the loop's bounded re-pop keys on
        this distinction."""
        return self._fatal

    def state_dict(self) -> dict:
        """The plan cursor: pipeline state after the last consumed plan
        (what the loop checkpoints as ``meta['pipeline']``)."""
        at = self._consumed or self._cursor0
        if at is None:
            raise RuntimeError("DataPlane holds no plan cursor before "
                               "start(); checkpoint the loop's pipeline "
                               "state instead")
        cursor, step = at
        return {"pipeline": cursor.as_dict(), "step": int(step)}

    # -- workers --------------------------------------------------------------
    def _bind_device(self) -> None:
        # the current CUDA device is per thread
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _get(self, q):
        try:
            return q.get(timeout=self.POLL_S)
        except queue.Empty:
            return None

    def _plan_worker(self) -> None:
        self._bind_device()
        cursor, step = self._cursor0
        while not self._stop.is_set():
            if not self._credits.acquire(timeout=self.POLL_S):
                # depth batches in flight: planning is throttled by the
                # consumer, the healthy steady state — a LOW stall count
                # means the pipeline is running dry
                self._c_stalls.inc()
                continue
            if self._stop.is_set():
                return
            try:
                with self._sp_plan:
                    plan, nxt = self.sampler.plan(cursor, step)
            except BaseException as e:   # planning is pure: a bug, not flaky
                self._out_q.put(("fatal", e))
                return
            self._plan_q.put((plan, nxt))
            cursor, step = nxt, step + 1

    def _gather_worker(self) -> None:
        self._bind_device()
        sink = self._dev_q if self._device_put else self._out_q
        while not self._stop.is_set():
            item = self._get(self._plan_q)
            if item is None:
                continue
            plan, cursor = item
            while not self._stop.is_set():
                with self._gather_cv:
                    self._gathers_started += 1
                    self._gather_cv.notify_all()
                try:
                    # injected gather fault: keyed to the PLAN's step and
                    # consumed on firing, so the retry of the same plan
                    # then succeeds
                    faults.raise_if("gather",
                                    step=int(getattr(plan, "step", -1)))
                    with self._sp_gather:
                        batch = self.sampler.assembler.assemble(plan)
                except BaseException as e:
                    # surface on the consuming call, then retry this plan
                    sink.put(("err", e))
                    if isinstance(e, MembershipChange):
                        # a peer is gone, not a flaky gather: the loop
                        # stops this plane
                        break
                    continue
                sink.put(("ok", batch, plan, cursor, None))
                break

    def _device_worker(self) -> None:
        self._bind_device()
        while not self._stop.is_set():
            item = self._get(self._dev_q)
            if item is None:
                continue
            if item[0] == "ok":
                try:
                    with self._sp_device_put:
                        batch, ready = self._put_batch(item[1])
                    item = ("ok", batch, item[2], item[3], ready)
                except BaseException as e:
                    item = ("err", e)
            self._out_q.put(item)

    def _put_batch(self, batch):
        """The host-to-card stage, with receipts: a batch already on the
        device passes through untouched (``plane.device_put_skipped``);
        host batches are charged by size to ``plane.device_put_bytes``.
        Returns (batch, the copy's CUDA event or None)."""
        if (isinstance(batch, dict) and batch
                and all(_on(v, self.device) for v in batch.values())):
            self._c_put_skipped.inc()
            return batch, None
        self._c_put_bytes.inc(sum(
            np.asarray(v).nbytes if not isinstance(v, torch.Tensor)
            else v.numel() * v.element_size()
            for v in batch.values() if not _on(v, self.device)))
        if self.device.type != "cuda":
            return to_device(batch, self.device), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        out = {}
        with torch.cuda.stream(self._copy_stream):
            for k, v in batch.items():
                if _on(v, self.device):
                    out[k] = v
                    continue
                t = torch.as_tensor(v)
                if t.device.type == "cpu":
                    # a pinned source makes the copy asynchronous; the
                    # host allocator keeps the block until the copy ends
                    t = t.contiguous().pin_memory()
                out[k] = t.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return out, ready

    def _adopt(self, batch, ready):
        """Hand an uploaded batch to the consuming thread's stream: wait
        for the copy, and mark each tensor used on that stream so its
        memory is not reused while the step reads it."""
        if ready is None:
            return batch
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ready)
        for v in batch.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(cur)
        return batch


class Prefetcher:
    """DEPRECATED one-deep async prefetch — a thin wrapper over a depth-1
    ``DataPlane`` whose "plans" are raw pipeline states and whose gather
    stage is the source's sequential ``batch``. New code consumes
    ``DataPlane`` (or the ``repro_torch.api`` loop, which owns one)."""

    def __init__(self, source, state: PipelineState, batch_size: int):
        warnings.warn(
            "repro_torch.data.pipeline.Prefetcher is deprecated; use "
            "DataPlane (depth-N pipelined plan→gather→device-put) instead",
            DeprecationWarning, stacklevel=2)

        class _Sequential:
            """Adapter: sequential batches as a pure 'planner'."""
            plan_is_pure = True

            def __init__(s):
                s.assembler = s

            def plan(s, pstate, step):
                return pstate, pstate.advance(batch_size, source.n)

            def assemble(s, pstate):
                return source.batch(pstate, batch_size)[0]

            def notify_consumed(s, plan):
                pass

        self._plane = DataPlane(_Sequential(), depth=1, device_put=False,
                                sync_launch=True)
        self._plane.start(state, 0)

    def next(self):
        batch, _plan, state = self._plane.next()
        return batch, state
