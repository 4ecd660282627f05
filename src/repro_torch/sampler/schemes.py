"""Example-selection schemes behind one ``Sampler`` API
(``repro.sampler.schemes`` at one host).

Every scheme is a PLANNER: it emits a device-free ``BatchPlan``
(``repro_torch.data.plan``) — the example ids of every row of the step's
batch, plus proposal probs / unbiasedness weights. The trainer's loop
drives two phases:

    handle = sampler.begin(pstate, step, params)              # scores
    batch, plan, pstate' = sampler.finish(handle, params)     # selects
    state, metrics = step_fn(state, batch, plan.is_flag)
    sampler.observe(plan, metrics["sample_scores"])           # feedback

``begin``/``finish`` degrade to a synchronous ``next_batch`` for schemes
that don't score out of band.

Schemes:

* ``uniform`` — sequential batches of b, plain SGD; still feeds scores
  into the store.
* ``presample`` — Algorithm 1's data side for the ``presample`` step
  kind (plans of B = ratio·b candidates; scoring, the τ gate and the
  resampling run inside the step).
* ``presample_host`` — Algorithm 1 with the scoring pass on the
  ``ScoreEngine`` path and selection on the host (``HostPresampleSampler``).
* ``presample_fused`` — the same with the candidate pool kept on the
  device; its plans are bitwise the host path's (``FusedPresampleSampler``).
* ``history`` — dataset-level importance sampling from the persistent
  score memory, gated on the store's coverage and τ: ``gather`` draws b
  ids with replacement ∝ the global distribution; ``sharded`` draws the
  exponential-race bottom-b (K6 on a CUDA device) with Horvitz–Thompson
  weights (``HistorySampler``).
* ``selective`` — Biggest-Losers-style selective backprop: the top-b of a
  sequential window by stored score, unweighted (``SelectiveSampler``).

Every scheme's ``state_dict`` is the reference's, key for key and dtype
for dtype (``sampler/store/{scores,seen,updates}``, ``sampler/epoch``,
and ``tau_ema`` or the ``history`` gate's state), so the score memory
crosses in checkpoints both ways. Many hosts and the injected
simulated-host collectives wait for a later slice.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch import obs
from repro_torch.data.pipeline import PipelineState
from repro_torch.data.plan import BatchPlan
from repro_torch.distributed import collectives
from repro_torch.sampler import selection
from repro_torch.sampler.assembly import Assembler
from repro_torch.sampler.store import ScoreStore


class Sampler:
    """Base: sequential planning + score-memory bookkeeping."""

    scheme = "base"
    uses_score_step = True   # False → the paper's on-device presample step
    plan_is_pure = True      # plan() reads only (pstate, step)

    def __init__(self, run_cfg, source, assembler=None, device=None):
        self.cfg = run_cfg.sampler
        self.icfg = run_cfg.imp
        self.b = run_cfg.shape.global_batch
        self.seed = run_cfg.seed
        self.source = source
        self.device = device     # where the selection kernels run (K6)
        self.host_id = getattr(source, "host_id", 0)
        self.n_hosts = getattr(source, "n_hosts", 1)
        self.store = ScoreStore(source.n, host_id=self.host_id,
                                n_hosts=self.n_hosts, ema=self.cfg.ema,
                                staleness=self.cfg.staleness)
        self.assembler = assembler or Assembler(source)
        self._epoch = np.zeros((), np.int64)
        self.engine = None       # repro_torch.scoring.ScoreEngine
        self.impl = selection.resolve_selection_impl(
            self.icfg.selection_impl, n=source.n, b=self.b,
            n_hosts=self.n_hosts)
        obs.counter(f"sampler.selection_impl.{self.impl}").inc()

    @property
    def fetch_size(self) -> int:
        return self.b

    def _tick_epoch(self, epoch: int) -> None:
        if int(self._epoch) != int(epoch):
            # decay toward the GLOBAL seen mean, so every host's shard
            # decays toward one attractor
            self.store.decay(self._global_seen_mean())
            self._epoch = np.asarray(epoch, np.int64)

    def _reduce_stats(self, temperature: float) -> np.ndarray:
        """Global sufficient stats [Σs_seen, #seen, Σs̃, Σs̃²] — the O(1)
        collective the sharded path reads instead of the full vector."""
        local = selection.shard_stats(self.store.scores, self.store.seen,
                                      temperature)
        return np.asarray(collectives.allreduce_stats(
            local, n_hosts=self.n_hosts), np.float64)

    def _global_seen_mean(self):
        if self.impl == "sharded":
            stats = self._reduce_stats(1.0)
            return float(stats[0] / stats[1]) if stats[1] else None
        if self.n_hosts == 1:
            return None                   # local mean IS the global mean
        sg = self.store.global_scores()
        m = sg >= 0
        return float(sg[m].mean()) if m.any() else None

    def notify_consumed(self, plan: BatchPlan) -> None:
        """Epoch bookkeeping at consumption time (the data plane calls
        this as plans leave it)."""
        self._tick_epoch(plan.epoch)

    # -- planning (the selection plane) ---------------------------------------
    def plan(self, pstate: PipelineState, step: int):
        gids = self.source.global_indices(pstate, self.fetch_size)
        plan = BatchPlan(step=step, epoch=pstate.epoch, gids=gids)
        return plan, pstate.advance(self.fetch_size, self.source.n)

    def next_batch(self, pstate: PipelineState, step: int):
        self._tick_epoch(pstate.epoch)
        plan, nxt = self.plan(pstate, step)
        return self.assembler.assemble(plan), plan, nxt

    # -- two-phase API ----------------------------------------------------------
    def begin(self, pstate: PipelineState, step: int, params=None):
        """Phase 1: the base scheme just records where to resume."""
        return {"pstate": pstate, "step": step}

    def finish(self, handle, params=None):
        """Phase 2: plan and materialise (batch, plan, pstate')."""
        return self.next_batch(handle["pstate"], handle["step"])

    # -- decoupled scoring engine ---------------------------------------------
    def bind_engine(self, engine) -> None:
        self.engine = engine

    def _gather_rows(self, local_scores, n_rows: int) -> np.ndarray:
        """Row-sharded score vector -> global (identity at one host)."""
        local = np.asarray(local_scores, np.float32).reshape(-1)
        return np.asarray(collectives.allgather_rows(
            local, n_rows=n_rows, n_hosts=self.n_hosts), np.float32)

    def refresh_plan(self, params, plan: BatchPlan) -> int:
        """Out-of-band store refresh keyed by a plan: score its rows
        through the engine's forward-only path and merge them. Returns the
        slots written."""
        if self.engine is None:
            raise RuntimeError("no ScoreEngine bound (call bind_engine)")
        fut = self.engine.score_plan(params, plan, self.assembler)
        local = fut[1].float().cpu().numpy()
        return self.store.update(plan.gids, self._gather_rows(local,
                                                              plan.n_rows))

    def refresh_scores(self, params, gids, epoch: int = 0) -> int:
        """Score arbitrary example ids (one plan) into the store."""
        gids = np.asarray(gids, np.int64)
        return self.refresh_plan(params, BatchPlan(step=-1, epoch=epoch,
                                                   gids=gids))

    def observe(self, plan, scores) -> None:
        """Close the feedback loop: the step's score vector for the plan's
        rows merges into the store."""
        lo, hi = plan["rows"]
        self.store.update(plan["gids"], np.asarray(scores)[lo:hi])

    def stats(self) -> dict:
        return {"store_coverage": self.store.coverage()}

    # -- checkpoint -----------------------------------------------------------
    def state_dict(self) -> dict:
        return {"store": self.store.state_dict(), "epoch": self._epoch}

    def load_state_dict(self, d) -> None:
        self.store.load_state_dict(d["store"])
        self._epoch = np.asarray(d["epoch"], np.int64).reshape(())


class UniformSampler(Sampler):
    scheme = "uniform"


class PresampleSampler(Sampler):
    """Algorithm 1's data side: plans of B = ratio·b candidates; scoring,
    τ gating and resampling belong to the ``presample`` step kind
    (``core.is_train``), which feeds the B-vector of scores back (−1 for
    candidates the step did not score)."""

    scheme = "presample"
    uses_score_step = False

    @property
    def fetch_size(self) -> int:
        return self.b * self.icfg.presample_ratio


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

    def __init__(self, run_cfg, source, assembler=None, device=None):
        super().__init__(run_cfg, source, assembler, device)
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

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["tau_ema"] = self.tau_ema
        return d

    def load_state_dict(self, d) -> None:
        super().load_state_dict(d)
        self.tau_ema = np.asarray(d.get("tau_ema", 0.0),
                                  np.float64).reshape(())


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


class HistorySampler(Sampler):
    """Dataset-level IS from the persistent score memory, drawn from the
    GLOBAL store distribution so every host draws the same plan.

    * ``"gather"`` — the O(n) global vector (gate-cadence cached), b ids
      drawn WITH replacement ∝ p, weights 1/(n·pᵢ).
    * ``"sharded"`` — O(1) sufficient-stat collectives refresh the
      τ/coverage gate at every plan, and the sample is the exponential-race
      bottom-b over score shards (K6 on a CUDA device) with an O(b·H)
      candidate exchange: ∝ p WITHOUT replacement, with the race-threshold
      Horvitz–Thompson weights keeping the estimator unbiased.

    ``last_plan`` holds the last sharded plan's receipt: host
    milliseconds of the stats reduction and of the whole plan and, on a
    CUDA device, the device milliseconds of the transfer, K6 and the
    bottom-k."""

    scheme = "history"
    plan_is_pure = False     # plans read the (mutable) score memory
    SALT = 9173              # the scheme's shared-PRNG / hash salt

    def __init__(self, run_cfg, source, assembler=None, device=None):
        super().__init__(run_cfg, source, assembler, device)
        self.tau_gate = np.zeros((), np.float64)   # store-τ at the last refresh
        self._obs = np.zeros((), np.int64)         # observe() count
        self._cov_global = 0.0                     # gate-cadence coverage
        self._gate_dirty = False                   # refresh due at next plan
        self.last_plan = {}
        if self.impl == "sharded" and source.n <= self.b:
            raise ValueError(f"history[sharded] needs n > batch "
                             f"({source.n} <= {self.b}): the WOR sample + "
                             f"HT threshold need b+1 distinct examples")

    @property
    def active(self) -> bool:
        # the gate reads the GLOBAL coverage refreshed at the same cadence
        # as τ, never a live per-host value
        return (self._cov_global >= self.cfg.min_coverage
                and float(self.tau_gate) > self.cfg.resolved_tau_th())

    def _maybe_refresh_gate(self):
        """The τ/coverage gate refresh is a PLAN-TIME read; observe only
        marks it due. Returns the refreshed distribution so the same read
        serves this step's sample."""
        if not self._gate_dirty:
            return None
        self._gate_dirty = False
        sg = self.store.global_scores(use_cache=True)
        p = self.store.distribution_from(sg, self.cfg.smoothing,
                                         self.cfg.temperature)
        self.tau_gate = np.asarray(self.store.tau_from(p), np.float64)
        self._cov_global = float((sg >= 0).mean())
        return p

    def _warmup_plan(self, pstate: PipelineState, step: int):
        # warm-up: uniform sequential plan, unit weights; scores fill the store
        gids = self.source.global_indices(pstate, self.b)
        plan = BatchPlan(step=step, epoch=pstate.epoch, gids=gids,
                         weights=np.ones((self.b,), np.float32))
        return plan, pstate.advance(self.b, self.source.n)

    def _plan_sharded(self, pstate: PipelineState, step: int):
        """O(b) selection: the gate, normalizer and sample all derive from
        this plan's O(1) stats reduction and O(b·H) candidate exchange."""
        t0 = time.perf_counter()
        dist = selection.GlobalDist(self._reduce_stats(self.cfg.temperature),
                                    n=self.store.n,
                                    smoothing=self.cfg.smoothing,
                                    temperature=self.cfg.temperature)
        receipt = {"stats_ms": (time.perf_counter() - t0) * 1e3}
        self.tau_gate = np.asarray(dist.tau(), np.float64)
        self._cov_global = dist.coverage
        if not self.active:
            self.last_plan = receipt
            return self._warmup_plan(pstate, step)
        gids, probs, w, _ = selection.sample_sharded(
            self.store, dist, self.b, seed=self.seed, salt=self.SALT,
            step=step, n_hosts=self.n_hosts, device=self.device,
            timing=receipt)
        receipt["plan_ms"] = (time.perf_counter() - t0) * 1e3
        self.last_plan = receipt
        plan = BatchPlan(step=step, epoch=pstate.epoch, gids=gids,
                         probs=probs, weights=w,
                         is_flag=max(float(self.tau_gate), 1.0))
        return plan, pstate.advance(self.b, self.source.n)

    def plan(self, pstate: PipelineState, step: int):
        if self.impl == "sharded":
            return self._plan_sharded(pstate, step)
        p = self._maybe_refresh_gate()
        if not self.active:
            return self._warmup_plan(pstate, step)
        if p is None:
            p = self.store.global_distribution(self.cfg.smoothing,
                                               self.cfg.temperature,
                                               use_cache=True)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.SALT, int(step)]))
        gids = rng.choice(self.store.n, size=self.b, replace=True,
                          p=p).astype(np.int64)
        # unbiased for the global mean: wᵢ = 1/(n·pᵢ), E_p[w·x] = x̄
        w = (1.0 / (self.store.n * p[gids])).astype(np.float32)
        # is_flag carries the live store-τ (≥1) for the optional lr boost
        plan = BatchPlan(step=step, epoch=pstate.epoch, gids=gids,
                         probs=p[gids], weights=w,
                         is_flag=max(float(self.tau_gate), 1.0))
        return plan, pstate.advance(self.b, self.source.n)

    def observe(self, plan, scores) -> None:
        super().observe(plan, scores)
        self._obs = self._obs + 1
        # τ over the store is O(n) host work: refresh the gate every
        # gate_every observations, not every step
        n_obs = int(self._obs)
        if n_obs == 1 or n_obs % max(self.cfg.gate_every, 1) == 0:
            self._gate_dirty = True

    def stats(self) -> dict:
        return {"store_coverage": self.store.coverage(),
                "store_tau": float(self.tau_gate),
                "sampler_active": float(self.active)}

    def state_dict(self) -> dict:
        d = super().state_dict()
        d["tau_gate"] = self.tau_gate
        d["obs"] = self._obs
        d["cov_global"] = np.asarray(self._cov_global, np.float64)
        # a refresh marked due but not yet run must survive resume
        d["gate_dirty"] = np.asarray(self._gate_dirty, np.uint8)
        return d

    def load_state_dict(self, d) -> None:
        super().load_state_dict(d)
        self.tau_gate = np.asarray(d["tau_gate"], np.float64).reshape(())
        self._obs = np.asarray(d.get("obs", 0), np.int64).reshape(())
        self._cov_global = float(np.asarray(d.get("cov_global", 0.0)))
        self._gate_dirty = bool(np.asarray(d.get("gate_dirty", 0)))


class SelectiveSampler(Sampler):
    """Top-k selective backprop over a sliding candidate window, ranked by
    the score memory instead of a fresh scoring pass. The ``"sharded"``
    impl ranks only the window rows each host owns and exchanges b
    candidates; the merged top-b is BITWISE the gather ranking."""

    scheme = "selective"
    plan_is_pure = False     # plans read the (mutable) score memory

    def __init__(self, run_cfg, source, assembler=None, device=None):
        super().__init__(run_cfg, source, assembler, device)
        self.window = (self.cfg.selective_window
                       or self.b * self.icfg.presample_ratio)
        # clamp to the dataset: a window past n would wrap duplicate ids
        # into one pool
        self.window = min(self.window, source.n)
        if self.window < self.b:
            raise ValueError(f"selective window {self.window} < batch {self.b}")

    def plan(self, pstate: PipelineState, step: int):
        pool = self.source.global_indices(pstate, self.window)
        if self.impl == "sharded":
            cand = collectives.exchange_topk(
                selection.local_rank_candidates(pool, self.store, self.b),
                k_each=self.b, n_hosts=self.n_hosts)
            order = selection.merge_rank(cand, self.b)
        else:
            sg = self.store.global_scores(use_cache=True)
            pri = sg[pool].astype(np.float64)
            # never-seen ids rank highest (optimistic init: visit everything)
            pri = np.where(pri >= 0, pri, np.inf)
            # stable partial sort: ties keep pool order
            order = np.argsort(-pri, kind="stable")[:self.b]
        plan = BatchPlan(step=step, epoch=pstate.epoch, gids=pool[order],
                         is_flag=1.0)
        return plan, pstate.advance(self.window, self.source.n)


SCHEMES = {c.scheme: c for c in
           (UniformSampler, PresampleSampler, HostPresampleSampler,
            FusedPresampleSampler, HistorySampler, SelectiveSampler)}


def make_sampler(run_cfg, source, assembler=None, device=None) -> Sampler:
    """The run's scheme, validated and routed as the reference routes it.
    ``device`` is where selection kernels run (K6 on a CUDA device)."""
    if run_cfg.imp.selection_impl not in ("auto", "gather", "sharded"):
        raise ValueError(
            f"unknown imp.selection_impl {run_cfg.imp.selection_impl!r}; "
            f"have ('auto', 'gather', 'sharded')")
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
    if scheme not in SCHEMES:
        raise ValueError(f"unknown sampler scheme {scheme!r}; "
                         f"have {sorted(SCHEMES)}")
    if not run_cfg.imp.enabled and scheme in ("history", "selective",
                                              "presample_host",
                                              "presample_fused"):
        # the IS kill-switch: score-memory and host-side selection IS
        # importance sampling (the on-device presample step gates itself)
        scheme = "uniform"
    return SCHEMES[scheme](run_cfg, source, assembler, device)
