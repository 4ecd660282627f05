"""Deterministic, resumable data pipeline (``repro.data.pipeline``, the
parts the ported slices run).

* ``PipelineState`` — the (epoch, cursor) iterator state; under the
  selection plane it is also the PLAN CURSOR.
* ``DataSource`` — the index math every source shares; ``SyntheticLM`` —
  seeded on-the-fly token streams with structured difficulty;
  ``SyntheticCLS`` — the paper's single-output classification setting.
  Sources are numpy, so their batches are bitwise the reference's.
* ``DataPlane`` — a depth-1 data plane that drives the sampler's two-phase
  ``begin``/``finish`` synchronously on the calling thread. Schemes whose
  plans read the score memory (``history``, ``selective``) and the other
  schemes without ``begin_finalize`` pass straight through to the
  sampler. For a sampler that carves its selection out of a pre-gathered
  candidate pool (``begin_finalize``, the fused presample) it plans and
  gathers the pool, moves it to the device, and hands it to the sampler.
  The threaded depth-N plane waits for a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs


@dataclasses.dataclass
class PipelineState:
    epoch: int = 0
    cursor: int = 0

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


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``; tensors already there pass
    through (``plane.device_put_bytes`` counts only what crossed)."""
    moved = sum(np.asarray(v).nbytes for v in batch.values()
                if not isinstance(v, torch.Tensor))
    if moved:
        obs.counter("plane.device_put_bytes").inc(moved)
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class DataPlane:
    """Depth-1 synchronous data plane over a plan-emitting sampler."""

    def __init__(self, sampler, device):
        self.sampler = sampler
        self.device = device
        self.finalize = (bool(getattr(sampler, "plan_is_pure", False))
                         and callable(getattr(sampler, "begin_finalize",
                                              None)))
        self._c_batches = obs.counter("plane.batches")

    def begin(self, pstate, step: int, params=None):
        if not self.finalize:
            return self.sampler.begin(pstate, step, params=params)
        with obs.span("plane.plan"):
            cplan, cursor = self.sampler.plan(pstate, step)
        with obs.span("plane.gather"):
            pool = self.sampler.assembler.assemble(cplan)
        with obs.span("plane.device_put"):
            pool = to_device(pool, self.device)
        return self.sampler.begin_finalize(cplan, pool, cursor, params=params)

    def finish(self, handle, params=None):
        if not self.finalize:
            return self.sampler.finish(handle, params=params)
        batch, plan, cursor = self.sampler.finish_finalize(handle,
                                                           params=params)
        self.sampler.notify_consumed(plan)
        self._c_batches.inc()
        return batch, plan, cursor
