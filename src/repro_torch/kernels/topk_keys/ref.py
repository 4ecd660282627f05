"""Plain torch versions of the K6 race keys (the oracle of
``repro.kernels.topk_keys.ref``).

The uint32 hash runs in int64 with every product reduced mod 2³²
(``kernels.fused_presample.race``), so the uniforms are bitwise the
reference's; the float tail is float32, as on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fused_presample.race import race_uniforms

EPS = 1e-12      # selection.EPS — the distribution_from score clamp


def race_keys_math(scores, seen, gids, ctx, fill_pow, scale, lam_over_n,
                   inv_t):
    """The per-element key math of the TPU kernel: hash → u → E = −log u,
    then p = s̃·scale + λ/n with s̃ = exp(log(max(s, EPS))·(1/T)) (fill
    for unseen), key = E / p. Scalars are float32 values."""
    u = race_uniforms(gids, ctx)
    s = scores.to(torch.float32)
    sp = torch.exp(torch.log(torch.clamp(s, min=EPS)) * inv_t)
    sp = torch.where(seen > 0, sp, fill_pow)
    p = sp * scale + lam_over_n
    return -torch.log(u) / p


def topk_race_keys_ref(scores, seen, gids_u32, ctx: int, *, fill_pow, total,
                       n_global, smoothing=0.1, inv_temp=1.0):
    """scores / seen / gids (n,) → race keys (n,) f32. ``total`` and
    ``fill_pow`` are the reduced global normalizer S̃ and the unseen fill
    mass; ``n_global`` is the dataset size (the λ-mixture's uniform mass
    is λ/n over GLOBAL ids)."""
    f32 = torch.float32
    lam = float(smoothing)
    scale = (torch.tensor(1.0 - lam, dtype=f32)
             / torch.tensor(total, dtype=f32)).item()
    lam_over_n = (torch.tensor(lam, dtype=f32)
                  / torch.tensor(n_global, dtype=f32)).item()
    return race_keys_math(
        torch.as_tensor(scores, dtype=f32), torch.as_tensor(seen, dtype=f32),
        torch.as_tensor(gids_u32).to(torch.int64), ctx,
        float(torch.tensor(fill_pow, dtype=f32)), scale, lam_over_n,
        float(torch.tensor(inv_temp, dtype=f32)))


def race_params(fill_pow, total, n_global, smoothing, inv_temp):
    """The kernel's f32 parameters [fill_pow, (1−λ)/S̃, λ/n, 1/T], rounded
    as the reference's ``ops.topk_race_keys`` rounds them."""
    lam = float(smoothing)
    return (np.float32(fill_pow),
            np.float32(1.0 - lam) / np.float32(total),
            np.float32(lam / n_global), np.float32(inv_temp))


def race_keys_ref(scores, seen, ctx: int, fill_pow, total, *, host_id=0,
                  n_hosts=1, n_global=None, smoothing=0.1, inv_temp=1.0):
    """What K6 computes, in plain torch on the tensors' device: the key of
    every slot of a shard (slot i's global id i·H + host_id, mod 2³²),
    +inf on padded lanes (seen < 0)."""
    n = scores.shape[0]
    fp = race_params(fill_pow, total, n if n_global is None else n_global,
                     smoothing, inv_temp)
    gids = (torch.arange(n, dtype=torch.int64, device=scores.device)
            * int(n_hosts) + int(host_id)) & 0xFFFFFFFF
    seen = seen.to(torch.float32)
    keys = race_keys_math(scores, seen, gids, ctx, *map(float, fp))
    return torch.where(seen < 0, torch.inf, keys)
