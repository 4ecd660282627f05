"""The paper's core quantities (Katharopoulos & Fleuret, ICML 2018), on
torch tensors (``repro.core.importance``).

* ``normalize_scores`` — ĝᵢ → gᵢ = ĝᵢ / Σĝⱼ (Algorithm 1, line 7).
* ``tau_inverse`` / ``tau`` — eq. 26: 1/τ = sqrt(1 − ‖g−u‖₂² / Σgᵢ²).
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
