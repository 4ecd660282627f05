"""Plain-torch oracle for the flash-attention kernel (K5), on the TPU
kernel's folded interface: q (B, sq, d), k and v (B, skv, d), where B
folds batch × heads."""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                        scale=None):
    """Query i sits at position ``q_offset + i`` and key j at position j;
    masked scores are −1e30 (a row with no valid key averages v)."""
    B, sq, d = q.shape
    skv = k.shape[1]
    scale = scale or d ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
