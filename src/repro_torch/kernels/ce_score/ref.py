"""Plain-torch versions of the CE + importance-score kernel.

Given logits z (tokens, V) and labels y (tokens,), per token:
    ce      = logsumexp(z) − z_y
    gnorm2  = ‖softmax(z) − onehot(y)‖₂²  (the paper's Ĝ² per token, eq. 20)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ce_score_ref(logits, labels):
    z = logits.float()
    lse = torch.logsumexp(z, dim=-1)
    zy = z.gather(-1, labels.long()[..., None])[..., 0]
    p = torch.exp(z - lse[..., None])
    onehot = F.one_hot(labels.long(), z.shape[-1]).float()
    return lse - zy, (p - onehot).square().sum(-1)


def ce_score_block_ref(logits, labels, alive, *, block_b=8):
    """Plain version of ``ops.ce_score_block``: direct per-token stats via
    ``ce_score_ref``, masked per-row sums, with the kernel's block-granular
    survival semantics — a row whose ``block_b``-sized row block is fully
    dead contributes 0.0, while a dead row sharing a block with a survivor
    is still computed."""
    B = labels.shape[0]
    ce, g2 = ce_score_ref(logits, torch.clamp(labels, min=0))
    mask = (labels >= 0).float()
    ce_sum = (ce * mask).sum(-1)
    g2_sum = (g2 * mask).sum(-1)
    bb = min(block_b, B)
    nb = -(-B // bb)
    a = F.pad(alive.float(), (0, nb * bb - B))
    blk_live = a.reshape(nb, bb).amax(dim=1) > 0.0
    row_live = blk_live.repeat_interleave(bb)[:B]
    zero = ce_sum.new_zeros(())
    return torch.where(row_live, ce_sum, zero), torch.where(row_live, g2_sum,
                                                            zero)
