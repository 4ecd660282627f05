"""Mixture-of-Experts FFN: top-k routing with GShard-style capacity
dispatch (``repro.models.moe``), at one host.

Tokens are split into groups of at most ``GROUP_TOKENS``; in each group an
expert takes at most ``_capacity`` (token, choice) pairs, in the order of
the flattened (token, k) choices, and the rest are dropped. The kept
choices are gathered into an (experts, capacity) layout (one zero pad row
fills the empty slots), the three expert products run over every expert
of the padded axis as batched matmuls, and each token sums its k gated
outputs by a gather (no atomic scatter, so a forward gives the same bits
from run to run). Padded experts are never routed to; their rows are all
zeros, so their weights get zero gradients, and the optimizer decays
them as the reference's does.

The router aux (load-balance) loss follows Switch Transformer:
``aux = E · Σ_e f_e · p_e · router_aux_coef`` with f the fraction of
(token, choice) pairs routed to e, dropped ones included, p the mean router
probability of e, and E the unpadded expert count. The router stays f32 in
a bf16 model, and its logits and softmax are f32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import act_fn, dense_init, dtype_of
from repro_torch.models.mlp import MLP

GROUP_TOKENS = 512   # the most tokens a dispatch group holds (the reference's)


def _capacity(n_tokens, m):
    cap = int(m.capacity_factor * m.top_k * n_tokens / m.n_experts)
    return max(cap, m.top_k)


def _groups(t):
    """The reference's group count at one host (its data-parallel degree
    1): ``t // GROUP_TOKENS`` (at least 1), lowered until it divides t."""
    g = max(t // GROUP_TOKENS, 1)
    while t % g:
        g -= 1
    return g


def top_k(probs, k):
    """The k largest entries of the last axis, ties to the lower index
    (``lax.top_k``'s order; ``torch.topk`` promises none): a stable
    descending sort."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


class Experts(nn.Module):
    """The routed experts' stacked weights: (E_pad, d, f) and (E_pad, f, d),
    drawn as the reference's (its fan-in is the leading, expert axis)."""

    def __init__(self, ep, d, f, dt, device, gen):
        super().__init__()
        self.w_gate = nn.Parameter(dense_init((ep, d, f), dt, device, gen))
        self.w_up = nn.Parameter(dense_init((ep, d, f), dt, device, gen))
        self.w_down = nn.Parameter(dense_init((ep, f, d), dt, device, gen))


class MoE(nn.Module):
    """``forward(x)`` (b, s, d) -> (y, aux). ``route(x)`` is its routing
    alone; ``(~route(x)["keep"]).sum()`` counts the (token, choice) pairs
    that capacity drops."""

    def __init__(self, cfg, device, gen):
        super().__init__()
        m = cfg.moe
        d, dt = cfg.d_model, dtype_of(cfg)
        self.cfg = cfg
        self.n_pad = m.n_experts_pad or m.n_experts
        self.act = act_fn(cfg.act)
        self.router = nn.Parameter(dense_init((d, m.n_experts), torch.float32,
                                              device, gen))
        self.experts = Experts(self.n_pad, d, m.d_expert, dt, device, gen)
        if m.n_shared_experts:
            self.shared = MLP(cfg, device, gen,
                              d_ff=m.d_expert * m.n_shared_experts,
                              gated=True)
        else:
            self.shared = None

    def route(self, x):
        """The routing of ``x`` (b, s, d): the dispatch groups ``g`` of
        ``tg`` tokens, the capacity ``cap``, the router ``probs`` (g, tg, E),
        and per (token, choice) of the flattened (tg·k) order its expert
        ``flat_e``, renormalised ``gate`` (g, tg, k), buffer position
        ``pos`` and ``keep`` (pos < cap); ``counts`` (g, E) of choices per
        expert."""
        m = self.cfg.moe
        k, E = m.top_k, m.n_experts
        b, s, d = x.shape
        t = b * s
        g = _groups(t)
        tg = t // g
        cap = _capacity(tg, m)
        xg = x.reshape(g, tg, d)

        # the router in f32 (its weight stays f32; a score_dtype cast is
        # undone here, as the reference's einsum promotes to f32)
        logits = xg.float() @ self.router.float()                # (g, tg, E)
        probs = torch.softmax(logits, dim=-1)
        gate, idx = top_k(probs, k)                              # (g, tg, k)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

        # each (token, choice)'s place in its expert's buffer, counted over
        # the group's flattened (token, k) order: its rank among its
        # expert's choices in a stable sort by expert (the reference's
        # exclusive cumsum over a one-hot, without the (g, t·k, E) one-hot)
        tk = tg * k
        flat_e = idx.reshape(g, tk)
        counts = torch.zeros((g, E), dtype=torch.long, device=x.device)
        counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
        order = torch.sort(flat_e, dim=1, stable=True).indices
        first = (counts.cumsum(1) - counts).gather(1, flat_e.gather(1, order))
        pos = torch.empty_like(flat_e).scatter_(
            1, order, torch.arange(tk, device=x.device).expand(g, tk) - first)
        return dict(g=g, tg=tg, cap=cap, probs=probs, gate=gate,
                    flat_e=flat_e, pos=pos, keep=pos < cap, counts=counts)

    def forward(self, x):
        m = self.cfg.moe
        ep, k, E = self.n_pad, m.top_k, m.n_experts
        b, s, d = x.shape
        r = self.route(x)
        g, tg, cap, probs = r["g"], r["tg"], r["cap"], r["probs"]
        flat_e, pos, keep, counts = r["flat_e"], r["pos"], r["keep"], \
            r["counts"]
        tk = tg * k
        xg = x.reshape(g, tg, d)
        flat_gate = r["gate"].reshape(g, tk) * keep

        # dispatch: the source row of every (expert, slot), pad row tg where
        # a slot is empty; the overflow bin ep * cap takes the dropped ones
        flat_tok = torch.arange(tg, device=x.device).repeat_interleave(k)
        slot = flat_e * cap + torch.clamp(pos, max=cap - 1)
        slot = torch.where(keep, slot, ep * cap)
        src = torch.full((g, ep * cap + 1), tg, dtype=torch.long,
                         device=x.device)
        src.scatter_(1, slot, flat_tok.expand(g, tk))
        src = src[:, :-1].reshape(g, ep, cap).transpose(0, 1)   # (ep, g, cap)
        rows = src + (torch.arange(g, device=x.device) * (tg + 1))[:, None]
        x_pad = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1).reshape(-1, d)
        xe = x_pad.index_select(0, rows.reshape(-1)).reshape(ep, g * cap, d)

        w = self.experts
        h = self.act(torch.bmm(xe, w.w_gate)) * torch.bmm(xe, w.w_up)
        ye = torch.bmm(h, w.w_down).reshape(ep * g * cap, d)

        # combine: each token gathers its k choices' outputs (any row for a
        # dropped one: its gate is 0) and sums them
        at = (flat_e * g + torch.arange(g, device=x.device)[:, None]) * cap \
            + torch.clamp(pos, max=cap - 1)
        picked = ye.index_select(0, at.reshape(-1)).reshape(g, tg, k, d)
        y = (picked * flat_gate.reshape(g, tg, k, 1).to(ye.dtype)).sum(2)

        if self.shared is not None:
            y = y + self.shared(xg)

        # Switch load-balance aux over every choice, dropped ones included
        frac = counts.sum(0).float() / (g * tg)                  # (E,)
        aux = E * (frac * probs.mean((0, 1))).sum() * m.router_aux_coef
        return y.reshape(b, s, d), aux
