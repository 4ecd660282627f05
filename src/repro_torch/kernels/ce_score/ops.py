"""Public wrappers for the CE + score kernels: per token (K1) and the
survival-gated chunk (K4).

On a CUDA tensor ``ce_score`` and ``ce_score_block`` launch the
hand-written Hopper kernels (``ce_score.ce_score_cuda``,
``ce_score.ce_score_block_cuda``) and raise if they cannot; the plain torch
versions (``ref.ce_score_ref``, ``ref.ce_score_block_ref``) run only for
tensors on the CPU or when the caller asks for them with
``interpret=True``. Neither op has a gradient, as the reference's Pallas
calls have no VJP.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import plain_route
from repro_torch.kernels.ce_score.ref import ce_score_block_ref, ce_score_ref


def ce_score(logits, labels, block_t=128, block_v=2048, interpret=None):
    """logits (..., V), labels (...) → per-token (ce, gnorm2), f32, of the
    labels' shape; the leading dims are flattened to tokens.

    ``block_t``/``block_v`` are the TPU kernel's tile sizes: they shape
    its grid, not the result, and the Hopper kernel (one warp per token
    over the whole vocab) needs none."""
    del block_t, block_v
    if torch.is_grad_enabled() and logits.requires_grad:
        raise RuntimeError(
            "ce_score has no gradient (the reference's Pallas kernel has no "
            "VJP): score_impl='pallas' serves forward-only scoring; train "
            "with 'fused', 'chunked' or 'naive'")
    if plain_route(logits, labels, interpret=interpret):
        return ce_score_ref(logits, labels)
    from repro_torch.kernels.ce_score.ce_score import ce_score_cuda
    shape = labels.shape
    V = logits.shape[-1]
    ce, g2 = ce_score_cuda(logits.reshape(-1, V),
                           labels.reshape(-1).to(torch.int32).contiguous())
    return ce.reshape(shape), g2.reshape(shape)


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
    if plain_route(logits, labels, alive, interpret=interpret):
        return ce_score_block_ref(logits, labels, alive, block_b=block_b)
    from repro_torch.kernels.ce_score.ce_score import ce_score_block_cuda
    return ce_score_block_cuda(logits, labels.to(torch.int32),
                               alive.to(torch.float32).contiguous(),
                               block_b)
