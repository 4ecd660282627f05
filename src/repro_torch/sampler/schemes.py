"""Example-selection schemes behind one ``Sampler`` API
(``repro.sampler.schemes``, the presample schemes at one host).

Every scheme is a PLANNER: it emits a device-free ``BatchPlan``
(``repro_torch.data.plan``) — the example ids of every row of the step's
batch, plus proposal probs / unbiasedness weights. The trainer's loop
drives two phases:

    handle = sampler.begin(pstate, step, params)              # scores
    batch, plan, pstate' = sampler.finish(handle, params)     # selects
    state, metrics = step_fn(state, batch, plan.is_flag)
    sampler.observe(plan, metrics["sample_scores"])           # feedback

Schemes ported in this slice:

* ``presample_host`` — Algorithm 1 with the scoring pass on the
  ``ScoreEngine`` path and selection on the host (``HostPresampleSampler``).
* ``presample_fused`` — the same with the candidate pool kept on the
  device: the engine scores it in place and the winners are gathered
  there; only the (B,) score vector and the (b,) selection cross to and
  from the host. Its plans are bitwise the host path's
  (``FusedPresampleSampler``).

The on-device ``presample`` step kind, ``uniform``, ``history`` and
``selective`` wait for later slices; ``make_sampler`` raises for them.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.data.pipeline import PipelineState
from repro_torch.data.plan import BatchPlan
from repro_torch.sampler import selection
from repro_torch.sampler.assembly import Assembler
from repro_torch.sampler.store import ScoreStore


class Sampler:
    """Base: sequential planning + score-memory bookkeeping."""

    scheme = "base"
    plan_is_pure = True      # plan() reads only (pstate, step)

    def __init__(self, run_cfg, source, assembler=None):
        self.cfg = run_cfg.sampler
        self.icfg = run_cfg.imp
        self.b = run_cfg.shape.global_batch
        self.seed = run_cfg.seed
        self.source = source
        self.store = ScoreStore(source.n, ema=self.cfg.ema,
                                staleness=self.cfg.staleness)
        self.assembler = assembler or Assembler(source)
        self._epoch = np.zeros((), np.int64)
        self.engine = None       # repro_torch.scoring.ScoreEngine

    @property
    def fetch_size(self) -> int:
        return self.b

    def _tick_epoch(self, epoch: int) -> None:
        if int(self._epoch) != int(epoch):
            self.store.decay()
            self._epoch = np.asarray(epoch, np.int64)

    def notify_consumed(self, plan: BatchPlan) -> None:
        """Epoch bookkeeping at consumption time (the data plane calls
        this as plans leave it)."""
        self._tick_epoch(plan.epoch)

    def plan(self, pstate: PipelineState, step: int):
        gids = self.source.global_indices(pstate, self.fetch_size)
        plan = BatchPlan(step=step, epoch=pstate.epoch, gids=gids)
        return plan, pstate.advance(self.fetch_size, self.source.n)

    def bind_engine(self, engine) -> None:
        self.engine = engine

    def observe(self, plan, scores) -> None:
        """Close the feedback loop: the step's score vector for the plan's
        rows merges into the store."""
        lo, hi = plan["rows"]
        self.store.update(plan["gids"], np.asarray(scores)[lo:hi])

    def stats(self) -> dict:
        return {"store_coverage": self.store.coverage()}


class HostPresampleSampler(Sampler):
    """Algorithm 1 with the scoring pass on the decoupled engine path.

    Per step: plan B = ratio·b sequential candidates, score them with the
    ``ScoreEngine`` (forward-only, ``score_dtype``), τ-gate on a host-side
    EMA mirroring the on-device controller, and either draw the b-of-B
    race-WOR sample ∝ Ĝ with the Horvitz–Thompson weights (IS phase) or
    take the first b with unit weights (uniform phase). The plan records
    ``src_rows`` so the assembler reuses the candidate rows."""

    scheme = "presample_host"
    plan_is_pure = False     # the selection plan needs engine scores
    SALT = 4211              # the scheme's shared-PRNG / hash salt

    def __init__(self, run_cfg, source, assembler=None):
        super().__init__(run_cfg, source, assembler)
        self.B = self.b * self.icfg.presample_ratio
        self.tau_th = self.icfg.resolved_tau_th(self.b)
        self.tau_ema = np.zeros((), np.float64)
        self.overlap = bool(self.icfg.overlap_scoring)
        # survival-pruned scoring switches every presample path to the
        # survivor-closed plan math (selection.presample_race_select_raw)
        self.prune = self.icfg.score_prune == "conservative"
        self.last_prune = None   # the last pruned pass's receipt (numpy)

    @property
    def active(self) -> bool:
        return bool(self.tau_ema > self.tau_th)

    def candidate_plan(self, pstate: PipelineState, step: int):
        """The (pure) B-candidate plan selection is carved out of."""
        gids = self.source.global_indices(pstate, self.B)
        plan = BatchPlan(step=step, epoch=pstate.epoch, gids=gids)
        return plan, pstate.advance(self.B, self.source.n)

    def _score(self, params, cands):
        # conservative mode scores through the chunked pass (nothing
        # pruned on the host path) so the score bytes equal the pruned
        # device pass's survivor bytes
        return (self.engine.score_chunked(params, cands) if self.prune
                else self.engine.score(params, cands))

    def begin(self, pstate: PipelineState, step: int, params=None):
        self._tick_epoch(pstate.epoch)
        cplan, nxt = self.candidate_plan(pstate, step)
        cands = self.assembler.assemble(cplan)
        handle = {"pstate": pstate, "step": step, "cplan": cplan,
                  "cands": cands, "nxt": nxt, "fut": None}
        if self.overlap and params is not None and self.engine is not None:
            handle["fut"] = self._score(params, cands)
        return handle

    def _require(self, params):
        if self.engine is None:
            raise RuntimeError(f"{self.scheme} scores through the decoupled "
                               f"engine — call bind_engine(ScoreEngine(...)) "
                               f"first")
        if params is None:
            raise RuntimeError(f"{self.scheme} needs params to score: pass "
                               f"them to begin() or finish()")

    def finish(self, handle, params=None):
        fut = handle["fut"]
        if fut is None:           # synchronous path (overlap off / no params)
            self._require(params)
            fut = self._score(params, handle["cands"])
        cplan = handle["cplan"]
        scores = self._pull_scores(fut)[:cplan.n_rows]
        plan = self._select_plan(cplan, scores, handle["step"])
        batch = self._materialize(handle, cplan, plan)
        return batch, plan, handle["nxt"]

    def _pull_scores(self, fut) -> np.ndarray:
        """Bring the (B,) score vector to the host — the one pool-sized
        device-to-host transfer of either presample path."""
        local = fut[1].float().cpu().numpy()
        obs.counter("sampler.d2h_bytes").inc(local.nbytes)
        if len(fut) > 3:      # pruned pass: (loss, scores, alive, stats)
            self._record_prune_stats(fut[3])
        return local

    def _record_prune_stats(self, stats) -> None:
        """[rows_killed, tiles_skipped, tiles_total, flops_saved], kept as
        ``last_prune`` and counted (when telemetry is on)."""
        st = self.last_prune = stats.double().cpu().numpy()
        obs.counter("kernels.prune.rows_killed").inc(int(st[0]))
        obs.counter("kernels.prune.blocks_skipped").inc(int(st[1]))
        obs.counter("kernels.prune.tiles_total").inc(int(st[2]))
        obs.counter("kernels.prune.flops_saved").inc(int(st[3]))

    def _prune_spec(self, step):
        """The pruned pass's race parameters (hash context, k), or None."""
        if not self.prune:
            return None
        return {"ctx": selection.hash_context(self.seed, self.SALT,
                                              int(step)),
                "k": self.b}

    def _select_plan(self, cplan, scores, step) -> BatchPlan:
        """(B,) fresh scores -> the step's selection plan: the one
        selection both the host and fused paths run."""
        if self.prune:
            return self._select_plan_pruned(cplan, scores, step)
        self.store.update(cplan.gids, scores)
        g = scores.astype(np.float64)
        g = g / max(g.sum(), 1e-20)
        tau = float(np.sqrt(self.B * np.square(g).sum()))
        self.tau_ema = np.asarray(
            tau if self.tau_ema == 0.0
            else self.icfg.ema * float(self.tau_ema)
            + (1.0 - self.icfg.ema) * tau, np.float64)
        if not self.active:
            return self._warmup_plan(cplan)
        ctx = selection.hash_context(self.seed, self.SALT, int(step))
        idx, g, w, _thr = selection.presample_race_select(
            scores, self.b, ctx=ctx)
        return BatchPlan(step=cplan.step, epoch=cplan.epoch,
                         gids=cplan.gids[idx], probs=g[idx], src_rows=idx,
                         weights=w, is_flag=max(float(self.tau_ema), 1.0))

    def _select_plan_pruned(self, cplan, scores, step) -> BatchPlan:
        """The survivor-closed plan math (``imp.score_prune=
        "conservative"``): every plan quantity is a function of the race's
        top-(k+1) keys alone, which conservative pruning preserves bit for
        bit. The race runs every step; only the b winners' (exact) scores
        refresh the store."""
        ctx = selection.hash_context(self.seed, self.SALT, int(step))
        idx, probs_hat, w, _thr, tau_hat = \
            selection.presample_race_select_raw(scores, self.b, ctx=ctx)
        self.store.update(cplan.gids[idx], scores[idx])
        self.tau_ema = np.asarray(
            tau_hat if self.tau_ema == 0.0
            else self.icfg.ema * float(self.tau_ema)
            + (1.0 - self.icfg.ema) * tau_hat, np.float64)
        if not self.active:
            return self._warmup_plan(cplan)
        return BatchPlan(step=cplan.step, epoch=cplan.epoch,
                         gids=cplan.gids[idx], probs=probs_hat,
                         src_rows=idx, weights=w,
                         is_flag=max(float(self.tau_ema), 1.0))

    def _warmup_plan(self, cplan) -> BatchPlan:
        """Uniform phase: the first b candidates, unit weights."""
        rows = np.arange(self.b, dtype=np.int64)
        return BatchPlan(step=cplan.step, epoch=cplan.epoch,
                         gids=cplan.gids[:self.b], src_rows=rows,
                         weights=np.ones((self.b,), np.float32))

    def _materialize(self, handle, cplan, plan):
        """Selection plan -> batch; reuses the candidate rows on host."""
        return self.assembler.assemble(plan,
                                       parent=(cplan, handle["cands"]))

    def stats(self) -> dict:
        return {"store_coverage": self.store.coverage(),
                "presample_tau": float(self.tau_ema),
                "sampler_active": float(self.active)}


class FusedPresampleSampler(HostPresampleSampler):
    """Algorithm 1 with the candidate pool DEVICE-RESIDENT end to end
    (``imp.presample_impl="fused"``): same planning, τ controller and
    selection as the host path, but the pool moves to the device once
    (``engine.score_select``), only the (B,) score vector comes back, and
    the winning rows are gathered on the device (``engine.take_rows``).
    Its candidate plans are pure cursor math, so the data plane plans and
    gathers the pool (``begin_finalize``/``finish_finalize``)."""

    scheme = "presample_fused"
    plan_is_pure = True

    @property
    def fetch_size(self) -> int:
        return self.B

    def plan(self, pstate: PipelineState, step: int):
        # what the data plane plans and gathers is the candidate POOL;
        # selection is carved out of it at finalize time
        return self.candidate_plan(pstate, step)

    def begin(self, pstate: PipelineState, step: int, params=None):
        self._tick_epoch(pstate.epoch)
        cplan, nxt = self.candidate_plan(pstate, step)
        return self.begin_finalize(cplan, self.assembler.assemble(cplan),
                                   nxt, params=params)

    def begin_finalize(self, cplan, pool, cursor, params=None):
        """Phase 1 over a materialised candidate pool (numpy or already on
        the device): move it to the device and score it."""
        handle = {"step": cplan.step, "cplan": cplan, "cands": pool,
                  "nxt": cursor, "fut": None, "dev": None}
        if self.overlap and params is not None and self.engine is not None:
            sel = self.engine.score_select(
                params, pool, prune=self._prune_spec(cplan.step))
            handle["dev"], handle["fut"] = sel["pool"], sel["fut"]
        return handle

    def finish(self, handle, params=None):
        if handle["fut"] is None:            # synchronous path (overlap off)
            self._require(params)
            sel = self.engine.score_select(
                params, handle["cands"],
                prune=self._prune_spec(handle["step"]))
            handle["dev"], handle["fut"] = sel["pool"], sel["fut"]
        return super().finish(handle, params)

    finish_finalize = finish

    def _materialize(self, handle, cplan, plan):
        # on-device gather out of the resident pool
        return self.engine.take_rows({"pool": handle["dev"]},
                                     plan.src_rows, plan.weights)


SCHEMES = {c.scheme: c for c in (HostPresampleSampler,
                                 FusedPresampleSampler)}


def make_sampler(run_cfg, source, assembler=None) -> Sampler:
    pimpl = run_cfg.imp.presample_impl
    if pimpl not in ("auto", "step", "host", "fused"):
        raise ValueError(f"unknown imp.presample_impl {pimpl!r}; "
                         f"have ('auto', 'step', 'host', 'fused')")
    if run_cfg.imp.score_prune not in ("off", "conservative"):
        raise ValueError(f"unknown imp.score_prune "
                         f"{run_cfg.imp.score_prune!r}; have ('off', "
                         f"'conservative')")
    scheme = run_cfg.sampler.scheme
    if scheme == "presample":
        if pimpl == "auto":
            pimpl = "host" if run_cfg.sampler.host_score else "step"
        scheme = {"step": "presample", "host": "presample_host",
                  "fused": "presample_fused"}[pimpl]
    if not run_cfg.imp.enabled:
        scheme = "uniform"       # the reference's IS kill-switch
    if scheme not in SCHEMES:
        raise NotImplementedError(
            f"sampler scheme {scheme!r} is not ported yet; have "
            f"{sorted(SCHEMES)} (sampler.scheme=presample with "
            f"imp.presample_impl=host|fused)")
    return SCHEMES[scheme](run_cfg, source, assembler)
