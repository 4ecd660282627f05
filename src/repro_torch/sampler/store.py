"""Persistent per-example score memory (``repro.sampler.store``).

A ``ScoreStore`` remembers the importance score (the paper's Ĝᵢ upper
bound, eq. 20) of every training example it has seen, so selection
schemes can reuse scores across epochs instead of paying a fresh scoring
pass per batch. It is a host-side numpy object, as in the reference, so
plans drawn from it are bitwise the reference's.

Sharding: ``StridedOwnership`` strides global ids over hosts — host ``h``
of ``H`` owns ids ``{i : i % H == h}`` in slots ``i // H``. Updates with
unowned, sentinel (negative) or non-finite scores are dropped. The
many-host gather and the rendezvous (HRW) ownership of the elastic
runtime wait for later slices.

Score dynamics:
* EMA merge on revisit: ``s ← a·s_old + (1-a)·s_new`` (first visit writes
  through), absorbing minibatch noise.
* Staleness decay between epochs: deviations shrink toward the mean
  (``s ← m + c·(s-m)``).
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.distributed.collectives import (gather_host_scores,
                                                 strided_shard_size)


class StridedOwnership:
    """The ``i % H == h`` partition — the id math every selection path,
    the K6 kernel's included, is built on."""

    kind = "strided"

    def __init__(self, n: int, host_id: int, n_hosts: int):
        self.n = int(n)
        self.host_id = int(host_id)
        self.n_hosts = int(n_hosts)
        self.n_local = strided_shard_size(self.n, self.host_id, self.n_hosts)

    def owned(self, gids):
        return (np.asarray(gids) % self.n_hosts) == self.host_id

    def slot(self, gids):
        return np.asarray(gids) // self.n_hosts

    def global_ids(self, slots):
        return np.asarray(slots) * self.n_hosts + self.host_id

    def my_global_ids(self) -> np.ndarray:
        """All ids this host owns, ascending (== global_ids(arange))."""
        return np.arange(self.n_local, dtype=np.int64) * self.n_hosts \
            + self.host_id


class ScoreStore:
    def __init__(self, n_examples: int, *, host_id: int = 0, n_hosts: int = 1,
                 ema: float = 0.9, staleness: float = 0.9):
        if not 0 <= host_id < n_hosts:
            raise ValueError(f"host_id {host_id} not in [0, {n_hosts})")
        self.ownership = StridedOwnership(n_examples, host_id, n_hosts)
        self.n = int(n_examples)
        self.host_id = self.ownership.host_id
        self.n_hosts = self.ownership.n_hosts
        self.ema = float(ema)
        self.staleness = float(staleness)
        self.n_local = self.ownership.n_local
        self.scores = np.zeros((self.n_local,), np.float32)
        self.seen = np.zeros((self.n_local,), np.uint8)
        self.updates = np.zeros((), np.int64)
        self._n_seen = 0   # incremental Σseen: coverage() stays O(1)
        # write version + gather cache: every mutation (update/decay/load)
        # bumps the version, so a cached global gather never serves a
        # post-observe read
        self.version = 0
        self._gcache = None
        self._gcache_version = -1
        self._c_hits = obs.counter("store.gather_cache.hits")
        self._c_misses = obs.counter("store.gather_cache.misses")
        self._c_inval = obs.counter("store.invalidations")

    # -- id mapping (delegated to the ownership policy) -----------------------
    def owned(self, gids: np.ndarray) -> np.ndarray:
        """Boolean mask of which global ids live on this host."""
        return self.ownership.owned(gids)

    def slot(self, gids: np.ndarray) -> np.ndarray:
        """Local slot of (owned) global ids."""
        return self.ownership.slot(gids)

    def global_ids(self, slots: np.ndarray) -> np.ndarray:
        return self.ownership.global_ids(slots)

    def my_global_ids(self) -> np.ndarray:
        """Every id this host owns, in slot order (ascending gid)."""
        return self.ownership.my_global_ids()

    # -- writes ---------------------------------------------------------------
    def update(self, gids, scores) -> int:
        """EMA-merge fresh scores; ids this host doesn't own and sentinel
        (score < 0) or non-finite entries are ignored. Returns how many
        slots were written."""
        gids = np.asarray(gids, np.int64).reshape(-1)
        scores = np.asarray(scores, np.float32).reshape(-1)
        if gids.shape != scores.shape:
            raise ValueError(f"ids {gids.shape} vs scores {scores.shape}")
        # the version bumps per CALL, not per local write: calls are in
        # lockstep across hosts, local writes are not
        self.version += 1
        self._c_inval.inc()
        keep = self.owned(gids) & (scores >= 0) & np.isfinite(scores)
        gids, scores = gids[keep], scores[keep]
        if gids.size == 0:
            return 0
        # a batch may repeat an id (sampling with replacement): keep the last
        slots = self.slot(gids)
        self._n_seen += int((self.seen[np.unique(slots)] == 0).sum())
        old_seen = self.seen[slots].astype(bool)
        merged = np.where(old_seen,
                          self.ema * self.scores[slots] + (1 - self.ema) * scores,
                          scores)
        self.scores[slots] = merged
        self.seen[slots] = 1
        self.updates += gids.size
        return int(gids.size)

    def decay(self, mean=None) -> None:
        """Staleness decay: pull seen scores toward the mean (epoch tick).
        ``mean`` defaults to this shard's seen mean; many-host callers pass
        the GLOBAL seen mean so every shard decays toward one attractor."""
        self.version += 1
        self._c_inval.inc()
        m = self.seen.astype(bool)
        if not m.any():
            return
        mean = float(self.scores[m].mean()) if mean is None else float(mean)
        self.scores[m] = mean + self.staleness * (self.scores[m] - mean)

    # -- reads ----------------------------------------------------------------
    def coverage(self) -> float:
        return self._n_seen / self.n_local if self.n_local else 0.0

    # The -1 sentinel marks never-seen slots (valid scores are >= 0); it is
    # also the gather's pad value, so "unseen" survives the collective.
    def sentinel_scores(self) -> np.ndarray:
        """This host's shard with unseen slots encoded as ``-1.0``."""
        return np.where(self.seen.astype(bool), self.scores,
                        np.float32(-1.0)).astype(np.float32)

    def global_scores(self, use_cache: bool = False) -> np.ndarray:
        """The GLOBAL score vector (length n, ``-1`` where never seen),
        reassembled from every host's strided shard.

        ``use_cache=True`` reuses the last gathered vector between writes;
        every ``update``/``decay``/restore bumps ``version``, so a stale
        cache never serves a post-observe read. Treat the result as
        read-only."""
        if use_cache:
            if self._gcache is not None \
                    and self._gcache_version == self.version:
                self._c_hits.inc()
                return self._gcache
            self._c_misses.inc()
        out = np.asarray(gather_host_scores(
            self.sentinel_scores(), host_id=self.host_id,
            n_hosts=self.n_hosts, n_global=self.n), np.float32)
        if use_cache:
            self._gcache, self._gcache_version = out, self.version
        return out

    @staticmethod
    def distribution_from(scores: np.ndarray, smoothing: float = 0.1,
                          temperature: float = 1.0) -> np.ndarray:
        """Sampling distribution p over a sentinel score vector: unseen
        slots (< 0) take the mean seen score, scores are sharpened by
        ``score^(1/T)`` and mixed with uniform, ``p = (1-λ)·p_score + λ·u``
        (λ > 0 bounds the weights 1/(N·pᵢ))."""
        s = np.asarray(scores, np.float64).copy()
        m = s >= 0.0
        fill = float(s[m].mean()) if m.any() else 1.0
        s[~m] = fill
        s = np.maximum(s, 1e-12)
        if temperature != 1.0:
            s = s ** (1.0 / temperature)
        p = s / s.sum()
        u = 1.0 / s.size
        return ((1.0 - smoothing) * p + smoothing * u).astype(np.float64)

    @staticmethod
    def tau_from(p: np.ndarray) -> float:
        """eq. 26's τ of a distribution (τ² = n·Σpᵢ²)."""
        p = np.asarray(p, np.float64)
        return float(np.sqrt(p.size * np.square(p).sum()))

    def distribution(self, smoothing: float = 0.1,
                     temperature: float = 1.0) -> np.ndarray:
        """Sampling distribution p over this host's slots."""
        return self.distribution_from(self.sentinel_scores(), smoothing,
                                      temperature)

    def global_distribution(self, smoothing: float = 0.1,
                            temperature: float = 1.0,
                            use_cache: bool = False) -> np.ndarray:
        """p over the GLOBAL id space."""
        return self.distribution_from(self.global_scores(use_cache),
                                      smoothing, temperature)

    def topk(self, gids_pool, k: int) -> np.ndarray:
        """The k highest-scoring ids of an owned candidate pool; never-seen
        ids rank highest (optimistic init: visit everything once)."""
        gids_pool = np.asarray(gids_pool, np.int64)
        if not self.owned(gids_pool).all():
            raise ValueError("topk pool contains unowned ids")
        slots = self.slot(gids_pool)
        pri = np.where(self.seen[slots].astype(bool),
                       self.scores[slots].astype(np.float64), np.inf)
        # stable partial sort: ties (e.g. all-unseen cold start) keep pool order
        order = np.argsort(-pri, kind="stable")[:k]
        return gids_pool[order]

    # -- checkpoint -----------------------------------------------------------
    def state_dict(self) -> dict:
        return {"scores": self.scores.copy(), "seen": self.seen.copy(),
                "updates": self.updates.copy()}

    def load_state_dict(self, d) -> None:
        scores = np.asarray(d["scores"], np.float32)
        seen = np.asarray(d["seen"], np.uint8)
        if scores.shape != (self.n_local,):
            raise ValueError(
                f"store shape {scores.shape} != ({self.n_local},) — "
                "checkpoint from a different dataset or host topology")
        self.scores = scores.copy()
        self.seen = seen.copy()
        self._n_seen = int(self.seen.astype(bool).sum())
        self.updates = np.asarray(d["updates"], np.int64).reshape(())
        self.version += 1
        self._c_inval.inc()
