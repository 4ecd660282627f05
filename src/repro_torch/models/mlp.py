"""Dense feed-forward block (SwiGLU)."""
from __future__ import annotations

from torch import nn

from repro_torch.models.common import act_fn, dense_init, dtype_of


class MLP(nn.Module):
    """``act(x @ w_gate) * (x @ w_up) @ w_down`` — the gated FFN of
    ``repro.models.mlp`` (``cfg.act`` in {"swiglu", "geglu"})."""

    def __init__(self, cfg, device, gen):
        super().__init__()
        if cfg.act not in ("swiglu", "geglu"):
            raise NotImplementedError(f"act {cfg.act!r} is not ported yet")
        d, f, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
        self.act = act_fn(cfg.act)
        self.w_gate = nn.Parameter(dense_init((d, f), dt, device, gen))
        self.w_up = nn.Parameter(dense_init((d, f), dt, device, gen))
        self.w_down = nn.Parameter(dense_init((f, d), dt, device, gen))

    def forward(self, x):
        return (self.act(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down
