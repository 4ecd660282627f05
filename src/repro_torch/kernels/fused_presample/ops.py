"""Survival-pruned presample pool scoring (``pruned_pool_score``).

The chunk loop and kill bounds of ``repro.kernels.fused_presample.ops``
around the K4 kernel (``repro_torch.kernels.ce_score.ops.ce_score_block``):
each time chunk of the pool's logits is scored by one kernel launch, and
rows that already lost the step's race stop being scored.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ce_score.ops import ce_score_block
from repro_torch.kernels.fused_presample.race import pool_exponentials

# per-token ceiling on the paper's ĝ² = ‖softmax(z) − onehot(y)‖₂² < 2: the
# most a still-unscored supervised token can add to a row's score
G2MAX = 2.0


def _block_defaults(B, T, block_b, block_t, chunk_t):
    if block_b is None:
        block_b = 8 if B >= 128 else 1
    if block_t is None:
        eighth = -(-T // 8)                       # ceil(T/8)
        block_t = min(128, -(-eighth // 8) * 8)   # …rounded up to a lane of 8
    if chunk_t is None:
        chunk_t = block_t
    if chunk_t % block_t:
        raise ValueError(f"chunk_t={chunk_t} must be a multiple of "
                         f"block_t={block_t}")
    return block_b, block_t, chunk_t


def pruned_pool_score(logits, labels, ctx, *, k, block_b=None, block_t=None,
                      block_v=2048, chunk_t=None, margin=1e-5,
                      interpret=None):
    """Survival-pruned pool scoring: chunk the CE pass over time blocks and
    stop paying for rows that already lost the race.

    Each pool row's race key is rᵢ = Eᵢ/sᵢ, where Eᵢ = −log(uᵢ) is a
    counter hash of (ctx, row) known before scoring. Between chunks the
    partial ĝ² bounds the score: sqrt(partial) ≤ sᵢ ≤ sqrt(partial +
    G2MAX·remaining supervised tokens), so rᵢ ∈ [Eᵢ/ŝᵢ, Eᵢ/s̲ᵢ]. θ, the
    (k+1)-th smallest key upper bound, caps the true (k+1)-th key; a row
    whose key lower bound exceeds θ·(1+margin) can never reach the
    top-(k+1) and is killed: its row block drops out of every later
    kernel launch. The ≥ k+1 rows with the smallest upper bounds stay
    alive every chunk, so survivors accumulate every chunk in the unpruned
    order and their scores are bitwise the unpruned chunked pass's
    (``k >= B - 1`` or a single chunk prunes nothing).

    logits: (B, T, V); labels: (B, T) (< 0 = unsupervised); ctx: the
    plan's hash context (int); k: rows the race will select. Block sizes
    default as in the reference: ``block_t ≈ T/8`` (≈ 8 prune
    checkpoints), ``block_b = 8`` for pools ≥ 128 rows else 1. A ragged
    last chunk is launched at its own length (its missing tokens count as
    unsupervised), never padded.

    Returns ``(scores, alive, loss_ps, stats)``: (B,) f32 scores (exact for
    survivors), the (B,) survival mask, per-row mean CE over supervised
    tokens, and an f32 (4,) receipt [rows_killed, tiles_skipped,
    tiles_total, flops_saved] counted in the reference's tiles.
    """
    B, T, V = logits.shape
    block_b, block_t, chunk_t = _block_defaults(B, T, block_b, block_t,
                                                chunk_t)
    dev = logits.device
    f32 = torch.float32
    labels = labels.to(torch.int32)
    nc = -(-T // chunk_t)
    mask = labels >= 0
    ntok = torch.clamp(mask.sum(-1).to(f32), min=1.0)
    # supervised tokens strictly after chunk c — the bound's "remaining"
    cnt = F.pad(mask, (0, nc * chunk_t - T)).reshape(B, nc, chunk_t) \
        .sum(2).to(f32)
    rem_after = torch.cat([cnt.flip(1).cumsum(1).flip(1)[:, 1:],
                           torch.zeros((B, 1), dtype=f32, device=dev)], 1)
    E = pool_exponentials(B, ctx, dev)

    prune = (k + 1 < B) and (nc > 1)
    bb = min(block_b, B)
    nb = -(-B // bb)
    nt_chunk = chunk_t // block_t

    alive = torch.ones((B,), dtype=f32, device=dev)
    cerun = torch.zeros((B,), dtype=f32, device=dev)
    g2run = torch.zeros((B,), dtype=f32, device=dev)
    skipped = torch.zeros((), dtype=f32, device=dev)
    for c in range(nc):
        blk = F.pad(alive, (0, nb * bb - B)).reshape(nb, bb).amax(1) > 0.0
        skipped = skipped + (nb - blk.to(f32).sum()) * nt_chunk
        lo = c * chunk_t
        ce_c, g2_c = ce_score_block(
            logits[:, lo:lo + chunk_t, :], labels[:, lo:lo + chunk_t], alive,
            block_b=block_b, block_t=block_t, block_v=block_v,
            interpret=interpret)
        cerun = cerun + ce_c
        g2run = g2run + g2_c
        if prune and c < nc - 1:
            s_lo = torch.sqrt(torch.clamp(g2run, min=1e-20))
            s_hi = torch.sqrt(torch.clamp(g2run + G2MAX * rem_after[:, c],
                                          min=1e-20))
            r_hi = E / s_lo                       # ≥ the true key
            r_lo = E / s_hi                       # ≤ the true key
            theta = torch.sort(r_hi).values[k]    # ≥ true (k+1)-th key
            alive = alive * (r_lo <= theta * (1.0 + margin)).to(f32)

    scores = torch.sqrt(torch.clamp(g2run, min=1e-20))
    Vp = -(-V // block_v) * block_v
    # flops_saved: ~12 flops/element over each skipped (bb, bt, vocab) slab
    stats = torch.stack([
        B - alive.sum(),
        skipped,
        torch.tensor(float(nc * nb * nt_chunk), dtype=f32, device=dev),
        skipped * torch.tensor(float(bb * block_t), dtype=f32, device=dev)
        * torch.tensor(Vp * 12.0, dtype=f32, device=dev),
    ])
    return scores, alive, cerun / ntok, stats
