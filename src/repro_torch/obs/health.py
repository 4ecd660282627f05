"""IS-health: is importance sampling actually paying for itself?
(``repro.obs.health`` on numpy; the port's own copy.)

The paper's second contribution (§3.3) is an estimator of the variance
reduction IS achieves, used to switch IS on only when it pays — the
method is self-monitoring by construction. This module turns the
quantities the runtime already computes every step (τ, gate decisions,
HT/unbiasedness weights) into an operator-facing health surface instead
of throwing them away:

* ``ess(weights)`` — Kish effective sample size ``(Σw)²/Σw²`` of the
  step's unbiasedness weights: how many "effective" uniform samples the
  weighted batch is worth. ``ess/b → 1`` means weights are flat (IS is
  doing nothing); a collapsing ESS means a few heavy weights dominate
  the gradient (variance is migrating into the estimator).
* ``variance_gain(tau)`` — the fraction of gradient variance removed
  versus uniform sampling: eq. 26 gives ``1/τ = sqrt(1 − ‖g−u‖²/Σg²)``,
  so the removed fraction is exactly ``1 − 1/τ²``.
* ``speedup_estimate(tau, B, b)`` — the §3.3 wall-clock criterion as a
  ratio: a uniform step of equivalent variance costs ``3·τ·b``
  forward-equivalents, an IS step costs ``B + 3b`` (backward ≈ 2×
  forward), so the estimated speedup is ``3τb / (B + 3b)`` — > 1 iff
  the paper's guaranteed-speedup condition ``B + 3b < 3τb`` holds.
  Schemes that reuse stored scores (history/selective) pay no scoring
  pass: ``B = 0`` and the estimate degenerates to τ itself.

``VarianceGainHook`` computes these per accepted step from the loop's
metrics + plan, publishes them as ``health.*`` gauges/counters, and
injects ``variance_gain`` / ``speedup_est`` / ``ess`` into the step's
metrics dict so they ride the metrics history, the log line, and the
JSONL telemetry for free.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.api.hooks import Hook


def ess(weights) -> float:
    """Kish effective sample size ``(Σw)² / Σw²`` of a weight vector."""
    w = np.asarray(weights, np.float64).reshape(-1)
    if w.size == 0:
        return 0.0
    denom = float(np.square(w).sum())
    if denom <= 0.0:
        return 0.0
    return float(w.sum()) ** 2 / denom


def variance_gain(tau: float) -> float:
    """Fraction of gradient variance removed vs uniform: ``1 − 1/τ²``
    (eq. 26 rearranged). 0 at τ=1 (no gain), → 1 as τ grows."""
    tau = float(tau)
    if tau <= 1.0:
        return 0.0
    return 1.0 - 1.0 / (tau * tau)


def speedup_estimate(tau: float, B: int, b: int) -> float:
    """§3.3 speedup ratio ``3τb / (B + 3b)``; > 1 iff the guaranteed-
    speedup condition ``B + 3b < 3τb`` holds. ``B`` is the scored
    candidate count (0 when scores are reused from the store)."""
    tau = max(float(tau), 1.0)
    return 3.0 * tau * b / (B + 3.0 * b)


class VarianceGainHook(Hook):
    """Per-step IS-health metrics from quantities the loop already has.

    Publishes (gauges unless noted):

    * ``health.tau`` — the scheme's live τ estimate.
    * ``health.tau_margin`` — τ − τ_th: > 0 means the gate holds open.
    * ``health.variance_gain`` — §3.3's variance-reduction estimate.
    * ``health.speedup_est`` — 3τb/(B+3b); > 1 iff IS pays wall-clock.
    * ``health.ess`` / ``health.ess_frac`` — effective sample size of
      the step's unbiasedness weights (absolute / fraction of b).
    * ``health.max_weight`` — the heaviest weight this step.
    * ``health.is_active`` — the gate decision (0/1).
    * ``health.gate_flips`` (counter) — gate transitions so far.

    Also injects ``variance_gain`` / ``speedup_est`` / ``ess`` into the
    step's metrics dict (metrics history + log line + telemetry).
    """

    def __init__(self):
        self._weights = None
        self._prev_active = None
        self._g = {n: obs.gauge("health." + n)
                   for n in ("tau", "tau_margin", "variance_gain",
                             "speedup_est", "ess", "ess_frac",
                             "max_weight", "is_active")}
        self._flips = obs.counter("health.gate_flips")

    # the plan carries this step's weights; metrics at step_end don't
    def on_step_start(self, loop, step, batch, meta):
        try:
            self._weights = meta["weights"]
        except (KeyError, TypeError):
            self._weights = None

    @staticmethod
    def _tau_and_costs(loop, metrics):
        """(τ, τ_th, B) for the experiment's scheme: presample schemes
        score B = ratio·b candidates per step; store-backed schemes
        reuse stored scores (B = 0) and gate on the store-τ."""
        run = loop.exp.run
        b = run.shape.global_batch
        scheme = getattr(loop.exp.sampler, "scheme", "uniform")
        if scheme in ("history", "selective"):
            tau = metrics.get("store_tau", 0.0)
            return tau, run.sampler.resolved_tau_th(), 0
        tau = metrics.get("presample_tau", metrics.get("tau", 0.0))
        return tau, run.imp.resolved_tau_th(b), b * run.imp.presample_ratio

    def on_step_end(self, loop, step, metrics):
        run = loop.exp.run
        b = run.shape.global_batch
        tau, tau_th, B = self._tau_and_costs(loop, metrics)
        active = float(metrics.get("is_active",
                                   metrics.get("sampler_active", 0.0)))
        vg = variance_gain(tau)
        sp = speedup_estimate(tau, B, b)
        g = self._g
        g["tau"].set(tau)
        g["tau_margin"].set(tau - tau_th)
        g["variance_gain"].set(vg)
        g["speedup_est"].set(sp)
        g["is_active"].set(active)
        if self._weights is not None:
            e = ess(self._weights)
            g["ess"].set(e)
            g["ess_frac"].set(e / max(b, 1))
            g["max_weight"].set(float(np.max(self._weights)))
            metrics.setdefault("ess", e)
        if self._prev_active is not None and bool(active) != self._prev_active:
            self._flips.inc()
        self._prev_active = bool(active)
        metrics.setdefault("variance_gain", vg)
        metrics.setdefault("speedup_est", sp)
        self._weights = None
