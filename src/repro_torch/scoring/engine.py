"""The decoupled scoring engine (``repro.scoring.engine``).

``ScoreEngine`` owns the forward-only score pass the presample samplers
run: no autograd (``torch.inference_mode``), no remat, floating
parameters cast to ``score_dtype`` (bf16 by default: scores rank samples,
they don't train them), and the pool kept on the device so the winners
are gathered there (``take_rows``). The survival-pruned pass
(``score_select(prune=...)``) routes through ``LM.pool_stats_pruned``
and the K4 kernel. Every scoring forward runs its attention through the
flash kernel K5 on a CUDA device, and ``imp.score_impl="pallas"`` takes
the per-token K1 (``LM.sample_stats`` → ``token_stats``).

``params`` is the train state's ``{name: tensor}`` dict. PyTorch runs
eagerly, so where the reference caches jitted functions per batch
structure this engine caches plain callables under the same keys (the
``engine.jit_compiles`` counter counts new structures). Calls block: the
returned tensors are computed when the call returns.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs


class ScoreEngine:
    """Standalone forward-only scorer for one ``LM`` under one run config."""

    def __init__(self, lm, run_cfg):
        self.lm = lm
        self.run = run_cfg
        self.device = next(lm.parameters()).device
        icfg = run_cfg.imp
        self.score_impl = icfg.score_impl
        sd = icfg.score_dtype
        self.score_dtype = None if sd in (None, "", "none") else sd
        self._fns = {}       # batch structure (+ race k) -> callable

    # -- the score function itself -------------------------------------------
    def fwd(self, params, batch):
        """(params, batch) -> (per_sample_loss, per_sample_score) f32; one
        forward pass, ``score_dtype`` compute, no grads, no remat."""
        loss_ps, scores = self.lm.sample_stats(
            batch, params=params, score_impl=self.score_impl,
            score_dtype=self.score_dtype)
        return loss_ps.float(), scores.float()

    def _key(self, batch):
        return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in batch.items()))

    def _fn(self, batch):
        key = self._key(batch)
        if key not in self._fns:
            obs.counter("engine.jit_compiles").inc()
            self._fns[key] = self.fwd
        return self._fns[key]

    def _fn_pruned(self, batch, k: int):
        """The survival-pruned pool pass for (batch structure, race k); the
        hash context is a per-call argument."""
        key = (self._key(batch), int(k))
        if key not in self._fns:
            obs.counter("engine.jit_compiles").inc()

            def pruned(params, batch, ctx):
                loss_ps, scores, alive, stats = self.lm.pool_stats_pruned(
                    batch, ctx, k=k, params=params,
                    score_dtype=self.score_dtype)
                return loss_ps.float(), scores.float(), alive, stats
            self._fns[key] = pruned
        return self._fns[key]

    # -- dispatch ------------------------------------------------------------
    def score(self, params, batch):
        """(loss_ps, scores) device tensors for ``batch``."""
        obs.counter("engine.dispatches").inc()
        with obs.span("engine.dispatch"):
            batch = self._to_device(batch)
            return self._fn(batch)(params, batch)

    def score_chunked(self, params, batch):
        """Chunk-accumulated scoring, nothing pruned: the conservative
        mode's host-path twin. Survivor scores of the pruned pass are
        bitwise this pass's, so a host scoring through this entry emits the
        plan bytes of the pruned device pass. Returns the pruned pass's
        4-tuple (alive all ones, zero tiles skipped)."""
        obs.counter("engine.dispatches").inc()
        with obs.span("engine.dispatch"):
            batch = self._to_device(batch)
            rows = int(batch["labels"].shape[0])
            # k = rows is the degenerate no-prune branch; the (unused)
            # race context is pinned to 0
            return self._fn_pruned(batch, rows)(params, batch, 0)

    def score_host(self, params, batch):
        """Blocking convenience: numpy (loss_ps, scores)."""
        loss_ps, scores = self.score(params, batch)
        return loss_ps.cpu().numpy(), scores.cpu().numpy()

    def score_plan(self, params, plan, assembler):
        """Score this host's rows of a ``BatchPlan`` (the store-refresh
        entry of ``Sampler.refresh_plan``): the assembler materialises the
        plan's rows and ``score`` runs them."""
        return self.score(params, assembler.assemble(plan))

    def _to_device(self, batch):
        """Every value as a tensor on the engine's device, charging what
        crosses from the host to ``engine.h2d_bytes``."""
        h2d = sum(np.asarray(v).nbytes for v in batch.values()
                  if not (isinstance(v, torch.Tensor)
                          and v.device == self.device))
        if h2d:
            obs.counter("engine.h2d_bytes").inc(h2d)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    # -- fused presample entries ---------------------------------------------
    def score_select(self, params, batch, prune=None):
        """Device-resident scoring for the fused presample path: move the
        candidate pool to the device once, score it, and keep it there so
        the winners are gathered on the device (``take_rows``). Returns
        ``{"pool": device batch, "fut": (loss_ps, scores)}``.

        ``prune={"ctx": ..., "k": ...}`` routes through the survival-pruned
        chunked pass (``LM.pool_stats_pruned``) and ``fut`` grows to
        (loss_ps, scores, alive, prune_stats)."""
        pool = self._to_device(batch)
        obs.counter("engine.dispatches").inc()
        with obs.span("engine.dispatch"):
            if prune is not None:
                ctx = int(prune["ctx"]) & 0xFFFFFFFF
                fut = self._fn_pruned(pool, int(prune["k"]))(params, pool,
                                                            ctx)
            else:
                fut = self._fn(pool)(params, pool)
        return {"pool": pool, "fut": fut}

    def take_rows(self, handle, idx, weights=None):
        """On-device row gather of the selection out of a ``score_select``
        pool: only the (b,) index vector (and the per-row weights) cross
        from the host."""
        obs.counter("engine.row_gathers").inc()
        with obs.span("engine.take_rows"):
            idx = np.ascontiguousarray(np.asarray(idx, np.int32))
            h2d = idx.nbytes + (0 if weights is None
                                else np.asarray(weights).nbytes)
            obs.counter("engine.h2d_bytes").inc(h2d)
            idx_t = torch.from_numpy(idx).to(self.device)
            batch = {k: v.index_select(0, idx_t)
                     for k, v in handle["pool"].items()}
            if weights is not None:
                batch["weights"] = torch.from_numpy(
                    np.asarray(weights, np.float32)).to(self.device)
            return batch
