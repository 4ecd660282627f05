"""The paper's core quantities (Katharopoulos & Fleuret, ICML 2018), on
torch tensors (``repro.core.importance``).

* ``normalize_scores`` — ĝᵢ → gᵢ = ĝᵢ / Σĝⱼ (Algorithm 1, line 7).
* ``tau_inverse`` / ``tau`` — eq. 26: 1/τ = sqrt(1 − ‖g−u‖₂² / Σgᵢ²); IS
  pays off when B + 3b < 3τb (``speedup_guaranteed``, §3.3).
* ``variance_reduction`` — eq. 23: (mean ‖G‖)²·B·‖g − u‖₂².
* ``sample_with_replacement`` / ``unbiased_weights`` — draw b of B ∝ g
  (line 8) and weight them wᵢ = 1/(B·gᵢ) (eq. 2-5), which keeps the
  weighted gradient unbiased for the uniform-expectation gradient.
* the τ-EMA controller (Algorithm 1, line 17).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def normalize_scores(scores, eps=1e-12):
    s = scores.float()
    return s / torch.clamp(s.sum(), min=eps)


def tau_inverse(g):
    """eq. 26, from a normalised score distribution g over B samples."""
    u = 1.0 / g.shape[0]
    dist2 = (g - u).square().sum()
    sum_g2 = torch.clamp(g.square().sum(), min=1e-20)
    return torch.sqrt(torch.clamp(1.0 - dist2 / sum_g2, 0.0, 1.0))


def tau(g):
    return 1.0 / torch.clamp(tau_inverse(g), min=1e-6)


def variance_reduction(gnorms):
    """eq. 23 from raw (unnormalised) per-sample gradient-norm estimates."""
    B = gnorms.shape[0]
    g = normalize_scores(gnorms)
    return gnorms.float().mean() ** 2 * B * (g - 1.0 / B).square().sum()


def unbiased_weights(g, idx):
    """wᵢ = 1/(B·gᵢ) for the sampled indices (eq. 2-5)."""
    return 1.0 / (g.shape[0] * torch.clamp(g[idx], min=1e-20))


def sample_with_replacement(generator, g, b):
    """Draw b indices ∝ g with replacement (Algorithm 1, line 8), from
    ``generator`` (a ``torch.Generator`` on g's device): the distribution
    of the reference's ``categorical`` over log(max(g, 1e-20)), not its
    bits."""
    return torch.multinomial(torch.clamp(g.float(), min=1e-20), b,
                             replacement=True, generator=generator)


def speedup_guaranteed(tau_val, B, b):
    """§3.3: guaranteed speedup iff B + 3b < 3·τ·b."""
    return B + 3 * b < 3 * tau_val * b


def max_variance_reduction(B, b):
    """§3.3: upper bound 1/b² − 1/B² on achievable variance reduction."""
    return 1.0 / b ** 2 - 1.0 / B ** 2


def max_speedup(B, b):
    """§3.3: max speedup (B+3b)/(3B) assuming backward = 2× forward."""
    return (B + 3 * b) / (3 * B)


class ISControllerState(NamedTuple):
    """EMA of τ (Algorithm 1, line 17) + bookkeeping; 0-d tensors."""
    tau_ema: torch.Tensor      # f32
    steps_is: torch.Tensor     # int32 — steps with IS active
    steps_total: torch.Tensor  # int32


def controller_init(device=None):
    z = lambda dt: torch.zeros((), dtype=dt, device=device)
    return ISControllerState(z(torch.float32), z(torch.int32),
                             z(torch.int32))


def controller_update(state: ISControllerState, g, a_tau: float,
                      was_is: bool) -> ISControllerState:
    t = tau(g)
    # the first observation seeds the EMA (τ of a real update is ≥ 1)
    ema = torch.where(state.tau_ema == 0.0, t,
                      a_tau * state.tau_ema + (1.0 - a_tau) * t)
    return ISControllerState(ema, state.steps_is + int(bool(was_is)),
                             state.steps_total + 1)
