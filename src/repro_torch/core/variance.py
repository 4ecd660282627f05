"""Variance-reduction diagnostics — the machinery behind the paper's
Fig. 1 (gradient-distance reduction) and Fig. 2 (score correlation)
(``repro.core.variance``).

These compute *true* per-sample gradient norms (batch-size-1 backprop, as
the paper does for its `gradient-norm` oracle), so they are meant for
small models and benchmark harnesses, not production steps: the (B, P)
gradient matrix holds 4·P bytes a row (0.39 GB at lm-100m, 12.9 GB at
llama3.2-3b).

Each function takes the port's ``LM``, which carries its own parameters,
and a batch dict of tensors with B leading rows. The draws of
``grad_distance_reduction`` go through
``repro_torch.core.importance.sample_with_replacement`` (looked up on the
module at each call) with the caller's ``torch.Generator``.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import Stacked
from repro_torch.checkpoint.interop import stacked
from repro_torch.core import importance as imp


def leaf_order(lm):
    """``lm``'s parameters in the order of the reference's flattened
    gradient: its leaves sorted as ``jax.tree_util.tree_leaves`` sorts the
    nested dicts (by the path's keys), each stacked leaf layer-major.
    Returns ``[(reference key, [tensor per layer])]``."""
    groups = stacked(dict(lm.named_parameters()))
    return [(key, list(v) if isinstance(v, Stacked) else [v])
            for key, v in sorted(groups.items(),
                                 key=lambda kv: kv[0].split("/"))]


def per_sample_gradients(lm, batch):
    """(B, P) f32 matrix of flattened per-sample gradients (the paper's
    oracle: backprop with batch size 1), one ``torch.autograd.grad`` of
    ``lm.loss(row, remat=False)`` (the router aux included) per row; the
    columns in the reference's leaf order (``leaf_order``)."""
    params = [p for _, ts in leaf_order(lm) for p in ts]
    B = batch["labels"].shape[0]
    out = torch.empty((B, sum(p.numel() for p in params)),
                      dtype=torch.float32, device=params[0].device)
    with torch.enable_grad():
        for i in range(B):
            one = {k: v[i:i + 1] for k, v in batch.items()}
            loss = lm.loss(one, remat=False)[0]
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            at = 0
            for p, g in zip(params, grads):
                n = p.numel()
                if g is None:
                    out[i, at:at + n] = 0.0
                else:
                    out[i, at:at + n] = g.reshape(-1)
                at += n
            del loss, grads
    return out


def sampling_distributions(lm, batch):
    """All four of the paper's distributions over the pre-sample batch:
    uniform / loss / upper-bound (ours) / gradient-norm (oracle). Returns
    (dists, per-sample gradient matrix)."""
    B = batch["labels"].shape[0]
    loss_ps, score = lm.sample_stats(batch)
    grads = per_sample_gradients(lm, batch)
    gnorm = torch.linalg.norm(grads, dim=1)
    return {
        "uniform": torch.full((B,), 1.0 / B, device=grads.device),
        "loss": imp.normalize_scores(loss_ps),
        "upper-bound": imp.normalize_scores(score),
        "gradient-norm": imp.normalize_scores(gnorm),
    }, grads


def grad_distance_reduction(lm, batch, b, generator, n_rounds=10):
    """Fig. 1: ‖mean-grad(B) − weighted-mean-grad(b)‖₂ per sampling scheme,
    normalised by the uniform distance, averaged over ``n_rounds`` draws
    of b from ``generator`` (a ``torch.Generator`` on the parameters'
    device), scheme by scheme and round by round in the reference's
    order."""
    dists, grads = sampling_distributions(lm, batch)
    gB = grads.mean(0)
    out = {}
    for name, g in dists.items():
        d = torch.zeros((), dtype=torch.float32, device=grads.device)
        for _ in range(n_rounds):
            idx = imp.sample_with_replacement(generator, g, b)
            idx = idx.to(grads.device)
            w = imp.unbiased_weights(g, idx)
            gb = (grads[idx] * w[:, None]).mean(0)
            d = d + torch.linalg.norm(gb - gB)
        out[name] = float(d) / n_rounds
    base = out["uniform"]
    return {k: v / base for k, v in out.items()}


def correlation_sse(lm, batch):
    """Fig. 2 metric: sum of squared errors of the (loss, upper-bound)
    probabilities against the gradient-norm ones. Returns (sse, dists)."""
    dists, _ = sampling_distributions(lm, batch)
    ref = dists["gradient-norm"]
    return {
        "loss": float((dists["loss"] - ref).square().sum()),
        "upper-bound": float((dists["upper-bound"] - ref).square().sum()),
    }, dists
