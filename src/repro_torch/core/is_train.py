"""Importance-sampled training step (``repro.core.is_train``).

This slice ports the ``host`` step kind: exactly b samples the HOST
already chose (host and fused presample, score memory, uniform), optional
``batch["weights"]``, and an ``is_flag`` scalar carrying the live
host-side τ. The weighted update is plain autograd through the model; the
τ controller (``_controller``), the lr τ-boost (``_tau_boost``) and the
optimizer apply (``_apply_update``) exist once here. The on-device
``presample`` kind and the ``plain`` kind wait for a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import importance as imp
from repro_torch.models.lm import LM, _valid_mask, token_stats


def train_state_init(lm: LM, optimizer):
    """The train state over ``lm``'s own parameters: ``params`` is the
    live ``{name: Parameter}`` dict (the optimizer updates it in place)."""
    params = dict(lm.named_parameters())
    device = next(iter(params.values())).device
    return {
        "params": params,
        "opt": optimizer.init(params),
        "ctrl": imp.controller_init(device),
        "step": 0,
    }


def _loss_scores_grads(lm: LM, batch, *, remat, score_impl, microbatches=1):
    """Weighted loss + grads + per-sample scores from the same forward,
    over ``lm``'s own parameters (grads keyed by parameter name)."""
    if microbatches != 1:
        raise NotImplementedError("gradient accumulation (microbatches > 1) "
                                  "is not ported yet")
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


def _apply_update(optimizer, state, loss, grads, extra):
    """Optimizer apply + metric assembly."""
    params, opt_state, m = optimizer.update(
        grads, state["opt"], state["params"], state["step"])
    metrics = dict(m)
    metrics.update(extra)
    metrics["loss"] = loss
    new_state = dict(state)
    new_state.update(params=params, opt=opt_state, step=state["step"] + 1)
    return new_state, metrics


def _controller(ctrl, g, ema, drawn_is, *, freeze_when_is=False):
    """τ-EMA update (Algorithm 1 line 17). ``freeze_when_is`` holds the EMA
    on importance-drawn batches — their scores are not a uniform sample."""
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


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """What flavour of step ``build_step`` emits: "host" (b host-chosen
    samples + is_flag scalar); "presample" and "plain" are not ported."""

    kind: str

    def __post_init__(self):
        if self.kind not in ("presample", "host", "plain"):
            raise ValueError(f"unknown StepSpec kind {self.kind!r}")


def build_step(lm: LM, run_cfg, optimizer, spec: StepSpec):
    """host: step(state, batch, is_flag) -> (state, metrics)."""
    if spec.kind != "host":
        raise NotImplementedError(f"StepSpec({spec.kind!r}) is not ported "
                                  f"yet; the host-chosen-batch schemes use "
                                  f"StepSpec('host')")
    icfg = run_cfg.imp

    def host_step(state, batch, is_flag):
        loss, per_sample, scores, grads = _loss_scores_grads(
            lm, batch, remat=run_cfg.remat, score_impl=icfg.score_impl,
            microbatches=run_cfg.microbatches)
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
