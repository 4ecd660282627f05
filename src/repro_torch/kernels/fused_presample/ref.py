"""Plain versions of the presample pool ops.

* ``pruned_pool_score_ref`` — the identical conservative recurrence with
  f64 bound math and per-chunk masked sums from the direct
  ``ce_score_block_ref`` formulation, which reproduces the kernel's
  block-granular freeze (rows in all-dead row blocks stop accumulating).
  Scores and alive masks agree with ``ops`` to the kernel-vs-plain
  tolerance.
* ``select_pool_ref`` / ``fused_presample_ref`` — the UNFUSED
  ``ce_score_ref`` → masked row sum → race keys → stable ascending sort →
  ``index_select`` composition. The keys use the shared
  ``pool_keys_math`` (the uint32 hash is bit-identical by definition);
  the bottom-(k+1) is a stable sort, not the op's int64 top-k. Indices,
  gathered rows and weights equal the op's on the same scores; scores
  agree to the K1-vs-plain tolerance.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ce_score.ref import ce_score_block_ref, ce_score_ref
from repro_torch.kernels.fused_presample.fused_presample import \
    pool_keys_math
from repro_torch.kernels.fused_presample.ops import _block_defaults
from repro_torch.kernels.fused_presample.race import pool_hash


def pool_exponentials_ref(n, ctx):
    """float64 twin of ``race.pool_exponentials``: the same uint32 hash,
    the −log tail in f64."""
    h = pool_hash(n, ctx).numpy()
    return -np.log((h >> 8).astype(np.float64) * 2.0 ** -24 + 2.0 ** -25)


def pruned_pool_score_ref(logits, labels, ctx, *, k, block_b=None,
                          block_t=None, chunk_t=None, margin=1e-5):
    """Plain version of ``ops.pruned_pool_score`` (same return contract;
    the receipt's flops_saved slot is 0)."""
    B, T, _ = logits.shape
    block_b, block_t, chunk_t = _block_defaults(B, T, block_b, block_t,
                                                chunk_t)
    labels = torch.as_tensor(labels).cpu()
    logits = torch.as_tensor(logits).cpu()
    nc = -(-T // chunk_t)
    mask = (labels >= 0).numpy()
    mask = np.pad(mask, ((0, 0), (0, nc * chunk_t - T)))
    ntok = np.maximum(mask.sum(-1).astype(np.float64), 1.0)
    cnt = mask.reshape(B, nc, chunk_t).sum(axis=2).astype(np.float64)
    rem_after = np.concatenate(
        [np.cumsum(cnt[:, ::-1], axis=1)[:, ::-1][:, 1:],
         np.zeros((B, 1), np.float64)], axis=1)
    E = pool_exponentials_ref(B, ctx)

    prune = (k + 1 < B) and (nc > 1)
    bb = min(block_b, B)
    nb = -(-B // bb)
    nt_chunk = chunk_t // block_t
    alive = np.ones((B,), np.float64)
    cerun = np.zeros((B,), np.float64)
    g2run = np.zeros((B,), np.float64)
    skipped = 0.0
    for c in range(nc):
        blk = np.max(np.pad(alive, (0, nb * bb - B)).reshape(nb, bb),
                     axis=1) > 0.0
        skipped += float(nb - blk.sum()) * nt_chunk
        lo = c * chunk_t
        ce_c, g2_c = ce_score_block_ref(
            logits[:, lo:lo + chunk_t], labels[:, lo:lo + chunk_t],
            torch.as_tensor(alive, dtype=torch.float32), block_b=block_b)
        cerun += ce_c.double().numpy()
        g2run += g2_c.double().numpy()
        if prune and c < nc - 1:
            s_lo = np.sqrt(np.maximum(g2run, 1e-20))
            s_hi = np.sqrt(np.maximum(g2run + 2.0 * rem_after[:, c], 1e-20))
            theta = np.partition(E / s_lo, k)[k]
            alive = alive * (E / s_hi <= theta * (1.0 + margin))

    scores = np.sqrt(np.maximum(g2run, 1e-20)).astype(np.float32)
    stats = np.array([B - alive.sum(), skipped,
                      float(nc * nb * nt_chunk), 0.0], np.float32)
    return (scores, alive.astype(np.float32),
            (cerun / ntok).astype(np.float32), stats)


def select_pool_ref(scores, ctx, *, k):
    """Plain version of ``ops.select_pool`` (same return contract):
    the same key math, selection by a stable ascending sort."""
    B = scores.shape[0]
    scores = scores.to(torch.float32)
    total = torch.clamp(scores.sum(), min=1e-20)
    g = scores / total
    if k >= B:
        return (torch.arange(B, dtype=torch.int64, device=scores.device), g,
                torch.full((B,), 1.0 / max(B, 1), dtype=torch.float32,
                           device=scores.device),
                torch.tensor(float("inf"), device=scores.device))
    ids = torch.arange(B, dtype=torch.int64, device=scores.device)
    r = pool_keys_math(scores, ids, ctx, 1.0 / total)
    order = torch.sort(r, stable=True).indices   # ties → low index
    idx = order[:k]
    thr = r[order[k]]
    probs = g[idx]
    pi = -torch.expm1(-probs * thr)
    w = 1.0 / (B * torch.clamp(pi, min=1e-30))
    return idx, probs, w, thr


def fused_presample_ref(logits, labels, rows, ctx, *, k):
    """Plain version of ``ops.fused_presample`` (same return contract)."""
    mask = (labels >= 0).to(torch.float32)
    _, g2 = ce_score_ref(logits.to(torch.float32),
                         torch.clamp(labels, min=0).to(torch.int32))
    s = (g2 * mask).sum(-1)
    scores = torch.sqrt(torch.clamp(s, min=1e-20))
    idx, _, w, _ = select_pool_ref(scores, ctx, k=k)
    sel = {name: v.index_select(0, idx) for name, v in rows.items()}
    return sel, idx, w, scores
