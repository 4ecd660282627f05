"""The selection plane's currency: device-free batch plans.

A ``BatchPlan`` describes ONE training step's *global* batch without
touching any data: the global example ids of every row, the proposal
probabilities they were drawn with (when the scheme is an importance
sampler), the unbiasedness weights to attach, and the epoch the rows
should be materialised from. Every ``repro_torch.sampler`` scheme emits plans
computed identically on all hosts — from a shared PRNG keyed on
``(run seed, scheme salt, step)`` over the GLOBAL index space — so
multi-host batch assembly is correct by construction: host ``h`` of ``H``
materialises rows ``[h·R/H, (h+1)·R/H)`` of the plan (its data-parallel
shard) and every host agrees on what every other host is training on.

Plans are pure numpy + ints (no device arrays), so they are cheap to
compare (``signature``), to pre-compute on pipeline worker threads
(``repro_torch.data.pipeline.DataPlane``), and to checkpoint: the pipeline
cursor ``(epoch, cursor)`` that goes into every checkpoint manifest IS
the plan cursor — re-planning from it reproduces the same plan sequence
bitwise (see README "Distributed selection plane").

``src_rows`` optionally records that this plan's rows were *selected out
of a parent plan* (the presample schemes pick b of B candidates); the
``Assembler`` uses it to reuse already-materialised candidate rows
instead of re-gathering from the source.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    step: int
    epoch: int
    gids: np.ndarray                      # (n_rows,) int64 global example ids
    probs: Optional[np.ndarray] = None    # (n_rows,) proposal probability
    weights: Optional[np.ndarray] = None  # (n_rows,) unbiasedness weights
    is_flag: float = 0.0                  # live τ (≥1) when IS is active
    src_rows: Optional[np.ndarray] = None # rows into the parent plan, if any

    def __post_init__(self):
        object.__setattr__(self, "gids",
                           np.ascontiguousarray(self.gids, np.int64))
        for f, dt in (("probs", np.float64), ("weights", np.float32),
                      ("src_rows", np.int64)):
            v = getattr(self, f)
            if v is not None:
                v = np.ascontiguousarray(v, dt)
                if v.shape != self.gids.shape:
                    raise ValueError(f"{f} shape {v.shape} != gids "
                                     f"{self.gids.shape}")
                object.__setattr__(self, f, v)

    @property
    def n_rows(self) -> int:
        return int(self.gids.shape[0])

    def row_slice(self, host_id: int, n_hosts: int) -> tuple:
        """The contiguous row range host ``host_id`` materialises (its
        data-parallel shard of the global batch)."""
        if self.n_rows % n_hosts:
            raise ValueError(f"plan rows {self.n_rows} not divisible by "
                             f"{n_hosts} hosts")
        local = self.n_rows // n_hosts
        return host_id * local, (host_id + 1) * local

    def signature(self) -> str:
        """Content hash of everything that defines the plan — the unit the
        cross-host determinism checks compare (bitwise: two hosts agree on
        a step iff their signatures match)."""
        h = hashlib.sha256()
        h.update(np.int64([self.step, self.epoch]).tobytes())
        h.update(self.gids.tobytes())
        for v in (self.probs, self.weights, self.src_rows):
            h.update(b"-" if v is None else v.tobytes())
        h.update(np.float64(self.is_flag).tobytes())
        return h.hexdigest()

    # dict-style access kept for the pre-plan ``meta`` call sites
    # (``meta["gids"]`` / ``meta["is_flag"]``) so downstream hooks and the
    # parity oracle read plans with either spelling.
    def __getitem__(self, key):
        if key == "rows":
            return (0, self.n_rows)
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None
