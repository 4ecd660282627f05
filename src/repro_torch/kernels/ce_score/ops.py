"""Public wrapper for the survival-gated CE + score chunk (K4).

On a CUDA tensor ``ce_score_block`` launches the hand-written Hopper
kernel (``ce_score.ce_score_block_cuda``) and raises if it cannot; the
plain torch version (``ref.ce_score_block_ref``) runs only for tensors on
the CPU or when the caller asks for it with ``interpret=True``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ce_score.ref import ce_score_block_ref


def _plain(*tensors, interpret=None) -> bool:
    """True when the plain version must run: the caller asked for it, or
    the tensors lie on the CPU (where no CUDA kernel can launch)."""
    return bool(interpret) or all(t.device.type == "cpu" for t in tensors)


def ce_score_block(logits, labels, alive, block_b=8, block_t=128,
                   block_v=2048, interpret=None):
    """Survival-gated chunk scoring: logits (B, Tc, V), labels (B, Tc)
    (< 0 = unsupervised), alive (B,) survival mask → masked per-row
    (ce_sum, g2_sum) f32 (B,) over this time chunk. Row blocks of
    ``block_b`` rows that are fully dead read nothing and return 0.0.

    ``block_t``/``block_v`` are the TPU kernel's tile sizes: they shape
    its grid and the prune receipt's tile count, not the result, and the
    Hopper kernel (one warp per token over the whole vocab) needs none."""
    del block_t, block_v
    if _plain(logits, labels, alive, interpret=interpret):
        return ce_score_block_ref(logits, labels, alive, block_b=block_b)
    from repro_torch.kernels.ce_score.ce_score import ce_score_block_cuda
    return ce_score_block_cuda(logits, labels.to(torch.int32),
                               alive.to(torch.float32).contiguous(),
                               block_b)
