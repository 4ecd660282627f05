"""Persistent per-example score memory (``repro.sampler.store`` at one host).

A ``ScoreStore`` remembers the importance score (the paper's Ĝᵢ upper
bound, eq. 20) of every training example it has seen, so selection
schemes can reuse scores across epochs.

The port runs one host, so the slot of an example is its global id; the
reference's host-sharded ownership, the multi-host gather and checkpoints
wait for later slices. Updates with sentinel (negative) or non-finite
scores are dropped.

Score dynamics:
* EMA merge on revisit: ``s ← a·s_old + (1-a)·s_new`` (first visit writes
  through), absorbing minibatch noise.
* Staleness decay between epochs: deviations shrink toward the running
  mean (``s ← m + c·(s-m)``).
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs


class ScoreStore:
    def __init__(self, n_examples: int, *, ema: float = 0.9,
                 staleness: float = 0.9):
        self.n = int(n_examples)
        self.ema = float(ema)
        self.staleness = float(staleness)
        self.scores = np.zeros((self.n,), np.float32)
        self.seen = np.zeros((self.n,), np.uint8)
        self._n_seen = 0   # incremental Σseen: coverage() stays O(1)
        self._c_inval = obs.counter("store.invalidations")

    # -- writes ---------------------------------------------------------------
    def update(self, gids, scores) -> int:
        """EMA-merge fresh scores; sentinel entries (score < 0, e.g. the
        presample uniform-phase padding) and non-finite scores are
        ignored. Returns how many slots were written."""
        gids = np.asarray(gids, np.int64).reshape(-1)
        scores = np.asarray(scores, np.float32).reshape(-1)
        if gids.shape != scores.shape:
            raise ValueError(f"ids {gids.shape} vs scores {scores.shape}")
        self._c_inval.inc()
        keep = (scores >= 0) & np.isfinite(scores)
        slots, scores = gids[keep], scores[keep]
        if slots.size == 0:
            return 0
        # a batch may repeat an id (sampling with replacement): keep the last
        self._n_seen += int((self.seen[np.unique(slots)] == 0).sum())
        old_seen = self.seen[slots].astype(bool)
        merged = np.where(old_seen,
                          self.ema * self.scores[slots] + (1 - self.ema) * scores,
                          scores)
        self.scores[slots] = merged
        self.seen[slots] = 1
        return int(slots.size)

    def decay(self) -> None:
        """Staleness decay: pull seen scores toward their mean (epoch
        tick)."""
        self._c_inval.inc()
        m = self.seen.astype(bool)
        if not m.any():
            return
        mean = float(self.scores[m].mean())
        self.scores[m] = mean + self.staleness * (self.scores[m] - mean)

    # -- reads ----------------------------------------------------------------
    def coverage(self) -> float:
        return self._n_seen / self.n if self.n else 0.0
