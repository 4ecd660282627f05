"""The presample pool's device ops (``repro.kernels.fused_presample.ops``).

* ``pruned_pool_score`` — survival-pruned pool scoring: the chunk loop and
  kill bounds around the K4 kernel
  (``repro_torch.kernels.ce_score.ops.ce_score_block``); each time chunk
  of the pool's logits is scored by one kernel launch, and rows that
  already lost the step's race stop being scored.
* ``select_pool`` — the race-WOR top-k over a pool's fresh scores: race
  keys, the bottom-(k+1), and Horvitz–Thompson weights off the (k+1)-th
  key, in one launch of ``fused_presample.pool_select_scores_cuda``.
* ``fused_presample`` — the whole device side of Algorithm 1's presample
  step: K1 per-token stats, then one ``pool_select`` launch (row scores →
  Σs → race keys → bottom-(k+1) → weights), then a gather of the winning
  rows, with no host synchronisation in between.

On CUDA tensors the kernels launch (or raise); the plain versions run
only for CPU tensors or ``interpret=True``. The selection semantics are
``selection.presample_race_select``'s (the host float64 twin): identical
uint32 hashes, a float32 tail, so candidate sets agree and key bytes do
not. No caller on the port's training path routes through
``select_pool`` or ``fused_presample`` (the reference's samplers select
on the host too); they are entry points of their own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import plain_route
from repro_torch.kernels.ce_score.ops import ce_score, ce_score_block
from repro_torch.kernels.fused_presample.fused_presample import (
    pool_select_cuda, pool_select_plain, pool_select_scores_cuda,
    pool_select_scores_plain)
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


def select_pool(scores, ctx, *, k, interpret=None):
    """Race-WOR top-k over one candidate pool's fresh (B,) scores →
    ``(idx, probs, weights, threshold)``, all tensors on the scores'
    device: the k winning rows (int64, ascending key), their g = s/Σs,
    their HT weights 1/(B·π) with π = 1 − exp(−g·τ*), and τ* the
    (k+1)-th smallest key (0-d f32). Ties break toward the lower row, as
    the reference's ``lax.top_k`` does. ``k >= B`` is the degenerate
    ratio-1 pool: every row, weights 1/B, threshold +inf. On CUDA tensors
    one ``pool_select`` launch computes it all."""
    scores = scores.to(torch.float32)
    if plain_route(scores, interpret=interpret):
        return pool_select_scores_plain(scores, ctx, k)[3:]
    return pool_select_scores_cuda(scores.contiguous(), ctx, k)[3:]


def fused_presample(logits, labels, rows, ctx, *, k, block_b=128,
                    block_t=128, block_v=2048, interpret=None):
    """One pass of the presample step's data side on the device.

    logits: (B, T, V) pool logits; labels: (B, T) targets (< 0 =
    unsupervised: K1 sees them clamped to 0, the row scores mask them
    out, as ``LM.sample_stats`` does); rows: dict of (B, ...) pool tensors
    to gather the winners from; ctx: the plan's
    ``selection.hash_context`` (uint32); k: rows to select.

    Returns ``(sel_rows, idx, weights, scores)``: the k winning rows (dict,
    on the device), their pool rows, HT weights, and the full (B,) score
    vector. ``block_*`` are the TPU kernels' tiles and shape nothing here.
    Forward only: K1 has no gradient."""
    del block_b, block_t, block_v
    V = logits.shape[-1]
    mask = (labels >= 0).contiguous()
    _, g2 = ce_score(logits.reshape(-1, V),
                     torch.clamp(labels.reshape(-1), min=0).to(torch.int32),
                     interpret=interpret)
    g2 = g2.reshape(labels.shape)
    if plain_route(g2, interpret=interpret):
        scores, _, _, idx, _, w, _ = pool_select_plain(g2, mask, ctx, k)
    else:
        scores, _, _, idx, _, w, _ = pool_select_cuda(g2, mask, ctx, k)
    sel = {name: v.index_select(0, idx) for name, v in rows.items()}
    return sel, idx, w, scores
