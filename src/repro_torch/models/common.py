"""Shared model components: norms, rotary embeddings, activations, init.

Weights keep the reference's layout — a projection is ``x @ W`` with
``W`` of shape (d_in, d_out) — so the port's parameters cross from and to
the JAX checkpoint format without transposes
(``repro_torch.checkpoint.interop``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Initialisers (the reference's distributions; torch draws its own numbers)
# ---------------------------------------------------------------------------
def _trunc_normal(shape, std, dtype, device, gen):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=gen)
    return w.to(dtype)


def dense_init(shape, dtype, device, gen, in_axis=0):
    """Truncated-normal fan-in init (±2σ, σ = 1/sqrt(fan_in))."""
    return _trunc_normal(shape, 1.0 / np.sqrt(shape[in_axis]), dtype,
                         device, gen)


def embed_init(shape, dtype, device, gen, std=0.02):
    return _trunc_normal(shape, std, dtype, device, gen)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm(scale, x, eps):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d, eps, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x):
        return rmsnorm(self.scale, x, self.eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split convention of repro.models.common)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim, theta):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def apply_rope(x, positions, theta):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = torch.from_numpy(rope_freqs(x.shape[-1], theta)).to(x.device)
    ang = positions[..., :, None].float() * freqs           # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                    # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def act_fn(name):
    # jax.nn.gelu defaults to the tanh approximation
    return {"swiglu": F.silu, "silu": F.silu, "tanh": torch.tanh,
            "geglu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]
