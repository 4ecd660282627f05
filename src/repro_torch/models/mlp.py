"""Dense feed-forward blocks (SwiGLU / GeGLU, and the ungated GELU)."""
from __future__ import annotations

from torch import nn

from repro_torch.models.common import act_fn, dense_init, dtype_of


class MLP(nn.Module):
    """The FFN of ``repro.models.mlp``: ``act(x @ w_gate) * (x @ w_up) @
    w_down`` for the gated activations ("swiglu", "geglu"), else the
    ungated ``act(x @ w_up) @ w_down`` (musicgen's "gelu"). ``d_ff``
    overrides ``cfg.d_ff`` and ``gated`` the activation's rule (the MoE's
    shared experts are gated whatever ``cfg.act``)."""

    def __init__(self, cfg, device, gen, d_ff=None, gated=None):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, dtype_of(cfg)
        if gated is None:
            gated = cfg.act in ("swiglu", "geglu")
        self.act = act_fn(cfg.act)
        if gated:
            self.w_gate = nn.Parameter(dense_init((d, f), dt, device, gen))
        else:
            self.w_gate = None
        self.w_up = nn.Parameter(dense_init((d, f), dt, device, gen))
        self.w_down = nn.Parameter(dense_init((f, d), dt, device, gen))

    def forward(self, x):
        if self.w_gate is None:
            return self.act(x @ self.w_up) @ self.w_down
        return (self.act(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down
