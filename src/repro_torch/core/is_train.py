"""Importance-sampled training step — the paper's Algorithm 1
(``repro.core.is_train``).

Per step (gate="cond", faithful):

    if tau_ema > tau_th:                       # IS phase
        score the pre-sample batch of B samples (ONE forward pass, eq. 20)
        g ∝ Ĝ;  update τ EMA (line 17)
        resample b of B with replacement ∝ g (line 8)
        weighted SGD step with wᵢ = 1/(B gᵢ)   (lines 9-10)
    else:                                      # uniform phase
        SGD step on the first b samples (uniform)
        τ EMA updated from the scores of those b — computed from the SAME
        logits as the loss, i.e. "for free" (line 15)

``gate="always"`` forces the IS branch, ``gate="never"`` is the uniform
baseline. ``gate="cond"`` reads τ̂ on the host to pick the branch: one
device synchronisation a step (the reference's ``lax.cond`` branches on
the device).

All step variants are ONE implementation (``build_step``) parameterized by
a ``StepSpec``:

* ``presample`` — Algorithm 1 above: B candidates in, scoring + τ-gated
  resampling inside the step;
* ``host``      — exactly b samples the HOST already chose (score-memory
  schemes and the host and fused presample paths), optional
  ``batch["weights"]``, an ``is_flag`` scalar carrying the live host-side
  τ;
* ``plain``     — uniform-SGD baseline, no controller, no score metrics.

The weighted update is plain autograd through the model over the live
parameters, which the optimizer updates in place; the IS branch therefore
scores its pool before the update. The τ controller (``_controller``),
the lr τ-boost (``_tau_boost``) and the unbiasedness weighting
(``_attach_weights``) exist once here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import importance as imp
from repro_torch.models.lm import LM, _valid_mask, token_stats


def train_state_init(lm: LM, optimizer, seed: int = 0):
    """The train state over ``lm``'s own parameters: ``params`` is the
    live ``{name: Parameter}`` dict (the optimizer updates it in place);
    ``rng`` the generator of the presample step's draws, on the
    parameters' device, seeded from ``seed``."""
    params = dict(lm.named_parameters())
    device = next(iter(params.values())).device
    return {
        "params": params,
        "opt": optimizer.init(params),
        "ctrl": imp.controller_init(device),
        "step": 0,
        "rng": torch.Generator(device=device).manual_seed(int(seed)),
    }


def _batch_rows(batch, idx):
    return {k: (v.index_select(0, idx) if v.dim() >= 1 else v)
            for k, v in batch.items()}


def _forward_backward(lm: LM, batch, *, remat, score_impl):
    """One forward + backward over ``lm``'s own parameters: the weighted
    loss, per-sample losses and scores (detached) and the grads (keyed by
    parameter name)."""
    logits = lm(batch, remat=remat)
    labels = batch["labels"]
    mask = _valid_mask(labels)
    ce, g2 = token_stats(logits, torch.clamp(labels, min=0), impl=score_impl)
    denom = torch.clamp(mask.sum(-1), min=1.0)
    per_sample = (ce * mask).sum(-1) / denom
    scores = torch.sqrt(torch.clamp((g2.detach() * mask).sum(-1), min=1e-20))
    w = batch.get("weights")
    loss = (per_sample * w).mean() if w is not None else per_sample.mean()
    del logits, ce, g2
    params = dict(lm.named_parameters())
    for p in params.values():
        p.grad = None
    loss.backward()
    grads = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return loss.detach(), per_sample.detach(), scores, grads


def _loss_scores_grads(lm: LM, batch, *, remat, score_impl, microbatches=1):
    """Weighted loss + grads + per-sample scores from the same forward.
    With ``microbatches`` > 1 the batch's rows split into that many equal
    consecutive parts, one forward and backward each; the grads are
    summed in f32 and averaged, as the reference's scan does."""
    if microbatches == 1:
        return _forward_backward(lm, batch, remat=remat,
                                 score_impl=score_impl)
    b = batch["labels"].shape[0]
    if b % microbatches:
        raise ValueError(f"batch of {b} rows does not split into "
                         f"{microbatches} microbatches")
    mb = b // microbatches
    acc, loss_sum, ps, sc = None, 0.0, [], []
    for i in range(microbatches):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, p, s, grads = _forward_backward(lm, part, remat=remat,
                                              score_impl=score_impl)
        if acc is None:
            acc = {n: g.float() for n, g in grads.items()}
        else:
            for n, g in grads.items():
                acc[n].add_(g)
        loss_sum = loss_sum + loss
        ps.append(p)
        sc.append(s)
        del grads
    for g in acc.values():
        g.div_(microbatches)
    return loss_sum / microbatches, torch.cat(ps), torch.cat(sc), acc


def _apply_update(optimizer, state, loss, grads, extra):
    """Optimizer apply + metric assembly shared by all step kinds."""
    params, opt_state, m = optimizer.update(
        grads, state["opt"], state["params"], state["step"])
    metrics = dict(m)
    metrics.update(extra)
    metrics["loss"] = loss
    new_state = dict(state)
    new_state.update(params=params, opt=opt_state, step=state["step"] + 1)
    return new_state, metrics


# ---------------------------------------------------------------------------
# the shared blocks (each exists exactly once)
# ---------------------------------------------------------------------------
def _controller(ctrl, g, ema, drawn_is, *, freeze_when_is=False):
    """τ-EMA update (Algorithm 1 line 17). ``freeze_when_is`` holds the EMA
    on importance-drawn batches — their scores are not a uniform sample
    (the host-chosen-batch step's rule)."""
    ctrl2 = imp.controller_update(ctrl, g, ema, drawn_is)
    if freeze_when_is and drawn_is:
        ctrl2 = ctrl2._replace(tau_ema=ctrl.tau_ema)
    return ctrl2


def _tau_boost(grads, cap, active, tau_val):
    """BEYOND-PAPER (§5 future work): scale the step like sqrt-batch-size
    scaling (capped) while IS is active."""
    if not active:
        return grads
    boost = min(max(float(tau_val), 1.0) ** 0.5, cap)
    return {n: g * boost for n, g in grads.items()}


def _attach_weights(batch, g, idx):
    """Unbiasedness weighting (eq. 2-5): gather the resampled rows and
    attach wᵢ = 1/(B·gᵢ)."""
    small = _batch_rows(batch, idx)
    small["weights"] = imp.unbiased_weights(g, idx)
    return small


# ---------------------------------------------------------------------------
# the one step implementation
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StepSpec:
    """What flavour of step ``build_step`` emits.

    kind: "presample" (B candidates in, Algorithm 1 in the step),
          "host" (b host-chosen samples + is_flag scalar),
          "plain" (uniform-SGD baseline).
    gate: presample only — "cond" (τ-gated), "always", "never".
    """

    kind: str
    gate: str = "cond"

    def __post_init__(self):
        if self.kind not in ("presample", "host", "plain"):
            raise ValueError(f"unknown StepSpec kind {self.kind!r}")
        if self.gate not in ("cond", "always", "never"):
            raise ValueError(f"unknown StepSpec gate {self.gate!r}")

    @property
    def flagged(self) -> bool:
        """Does the emitted step take the extra ``is_flag`` operand?"""
        return self.kind == "host"


def build_step(lm: LM, run_cfg, optimizer, spec: StepSpec):
    """The unified step. Signatures by kind:

    presample: step(state, big_batch)          (B = ratio·b leading rows)
    host:      step(state, batch, is_flag)     (exactly b rows)
    plain:     step(state, batch)              (exactly b rows)
    """
    icfg = run_cfg.imp

    def update_core(batch):
        return _loss_scores_grads(lm, batch, remat=run_cfg.remat,
                                  score_impl=icfg.score_impl,
                                  microbatches=run_cfg.microbatches)

    if spec.kind == "plain":
        def plain_step(state, batch):
            loss, _, _, grads = update_core(batch)
            return _apply_update(optimizer, state, loss, grads, {})
        return plain_step

    if spec.kind == "host":
        def host_step(state, batch, is_flag):
            loss, per_sample, scores, grads = update_core(batch)
            if icfg.score_by == "loss":
                scores = per_sample
            scores = scores.float()
            g = imp.normalize_scores(scores)
            drawn_is = float(is_flag) > 0.5
            ctrl = _controller(state["ctrl"], g, icfg.ema, drawn_is,
                               freeze_when_is=True)
            if icfg.lr_tau_boost_cap > 0:
                # IS-drawn batches carry the live host-side τ in is_flag
                grads = _tau_boost(grads, icfg.lr_tau_boost_cap, drawn_is,
                                   is_flag)
            return _apply_update(
                optimizer, dict(state, ctrl=ctrl), loss, grads,
                {"tau": ctrl.tau_ema, "is_active": float(drawn_is),
                 "sample_scores": scores})
        return host_step

    # presample: Algorithm 1 with the τ gate
    b = run_cfg.shape.global_batch
    B = b * icfg.presample_ratio
    tau_th = icfg.resolved_tau_th(b)
    gate = spec.gate

    def is_branch(state, big_batch):
        # Algorithm 1 lines 6-10: the scoring pass is forward-only, on the
        # pre-update params; its outputs are cloned out of inference mode
        # because the weights enter the autograd graph of the update
        loss_ps, scores = (t.clone() for t in lm.sample_stats(
            big_batch, score_impl=icfg.score_impl))
        if icfg.score_by == "loss":
            scores = loss_ps            # baseline scheme (paper §4: "loss")
        scores = scores.float()
        g = imp.normalize_scores(scores)
        idx = imp.sample_with_replacement(state["rng"], g, b)
        loss, _, _, grads = update_core(_attach_weights(big_batch, g, idx))
        ctrl = _controller(state["ctrl"], g, icfg.ema, True)
        return loss, grads, ctrl, True, scores

    def uniform_branch(state, big_batch):
        # Algorithm 1 lines 12-15: τ refreshed from the b-sample forward
        small = {k: v[:b] for k, v in big_batch.items()}
        loss, per_sample, scores, grads = update_core(small)
        if icfg.score_by == "loss":
            scores = per_sample
        scores = scores.float()
        g = imp.normalize_scores(scores)
        ctrl = _controller(state["ctrl"], g, icfg.ema, False)
        # only the first b of B candidates were scored; pad with the -1
        # sentinel so the score memory ignores the rest
        scores_B = torch.cat([scores, scores.new_full((B - b,), -1.0)])
        return loss, grads, ctrl, False, scores_B

    def presample_step(state, big_batch):
        if gate == "cond":
            use_is = float(state["ctrl"].tau_ema) > tau_th   # host sync
        else:
            use_is = gate == "always"
        branch = is_branch if use_is else uniform_branch
        loss, grads, ctrl, was_is, scores = branch(state, big_batch)
        if icfg.lr_tau_boost_cap > 0:
            grads = _tau_boost(grads, icfg.lr_tau_boost_cap, was_is,
                               ctrl.tau_ema)
        return _apply_update(
            optimizer, dict(state, ctrl=ctrl), loss, grads,
            {"tau": ctrl.tau_ema, "is_active": float(was_is),
             # per-candidate Ĝ for the persistent score memory (B-vector,
             # -1 where this step produced no score)
             "sample_scores": scores})

    return presample_step


# ---------------------------------------------------------------------------
# thin named wrappers (the reference's call sites)
# ---------------------------------------------------------------------------
def build_train_step(lm: LM, run_cfg, optimizer, *, gate=None):
    """step(state, big_batch) -> (state, metrics); ``big_batch`` holds
    B = presample_ratio × b samples (leading axis B)."""
    gate = gate or ("cond" if run_cfg.imp.enabled else "never")
    return build_step(lm, run_cfg, optimizer, StepSpec("presample", gate=gate))


def build_score_step(lm: LM, run_cfg, optimizer):
    """step(state, batch, is_flag) for the host-side sampler schemes:
    exactly b host-chosen samples, optional ``batch["weights"]``, and
    per-sample scores in the metrics for the score memory. ``is_flag`` is
    0 for a uniform-drawn batch, else the sampler's host-side τ (≥ 1);
    the τ EMA is refreshed only from uniform-drawn batches."""
    return build_step(lm, run_cfg, optimizer, StepSpec("host"))


def build_uniform_step(lm: LM, run_cfg, optimizer):
    """Plain-SGD baseline step on a batch of exactly b samples."""
    return build_step(lm, run_cfg, optimizer, StepSpec("plain"))
