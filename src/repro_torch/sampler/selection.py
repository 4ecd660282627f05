"""Presample race selection: the numpy selection math of
``repro.sampler.selection`` that the presample schemes run, copied so the
port's plans stay bitwise equal to the reference's.

* **Counter-based race keys.** Every (plan, pool row) gets a uniform
  ``u ∈ (0,1)`` from a pure integer hash, giving the exponential race key
  ``r_i = E_i / p_i`` with ``E_i = −log u_i``; the k smallest keys are a
  probability-proportional-to-``p`` sample without replacement.
* **Unbiasedness via the race threshold.** Conditioned on the (k+1)-th
  smallest key τ*, each selected row was included with probability
  ``π_i = 1 − exp(−p_i·τ*)``; the Horvitz–Thompson weights
  ``w_i = 1/(n·π_i)`` keep the weighted-mean estimator unbiased.

The sharded store selection (``history``/``selective``) is not ported yet.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# counter-based uniforms: a pure function of (seed, salt, step, global id)
# ---------------------------------------------------------------------------
_M32 = np.uint32(0xFFFFFFFF)


def _fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finalizer (vectorized, wraps mod 2^32)."""
    with np.errstate(over="ignore"):    # uint32 wrap IS the hash
        x = x.astype(np.uint32)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return x


def hash_context(seed: int, salt: int, step: int) -> int:
    """The per-plan hash context: mixes (seed, scheme salt, step) once so
    the per-id loop is a single multiply-xor-finalize. Pure int math —
    the device pass computes the identical value."""
    c = (int(seed) ^ (int(salt) * 0x9E3779B9) ^ (int(step) * 0xC2B2AE3D)) \
        & 0xFFFFFFFF
    return int(_fmix32(np.uint32(c)))


def hash_uniform(gids, ctx: int) -> np.ndarray:
    """Deterministic uniforms u(step, gid) ∈ (0,1), float64.

    24 mantissa bits from a double-finalized 32-bit hash, offset by 2⁻²⁵
    so u is never 0 (−log u stays finite). Identical on every host for
    the same (ctx, gid) — this is what replaces the shared sequential
    PRNG stream on the sharded path."""
    g = np.atleast_1d(np.asarray(gids, np.int64))
    with np.errstate(over="ignore"):    # uint32 wrap IS the hash
        x = (g & 0xFFFFFFFF).astype(np.uint32) \
            ^ ((g >> 32) & 0xFFFFFFFF).astype(np.uint32) \
            * np.uint32(0x85EBCA6B)
        h = _fmix32(x * np.uint32(0x9E3779B9) ^ np.uint32(ctx))
        h = _fmix32(h + np.uint32(0x6A09E667))
    return (h >> np.uint32(8)).astype(np.float64) * 2.0 ** -24 + 2.0 ** -25


def ht_weights(probs, threshold: float, n: int) -> np.ndarray:
    """Unbiasedness weights for the race sample: conditioned on τ*, id i
    is in iff E_i < p_i·τ*, so π_i = 1 − exp(−p_i·τ*) and the mean
    estimator (1/n)Σ x_i/π_i ... = Σ w_i·x_i with w_i = 1/(n·π_i) is
    unbiased (bottom-k sketches) — the WOR analogue of 1/(n·p_i)."""
    pi = -np.expm1(-np.asarray(probs, np.float64) * float(threshold))
    return (1.0 / (n * np.maximum(pi, 1e-300))).astype(np.float32)


def presample_race_select(scores, k: int, *, ctx: int):
    """Race-WOR selection of k of B presample candidates ∝ their fresh
    scores — the ONE host selection both presample paths (``host`` and
    ``fused``) share, which is what makes their plans bitwise identical.

    Normalise the candidate scores to the paper's ĝ, key every pool row
    with the deterministic exponential race key r = −log(u(row, ctx))/g
    (ids here are pool positions 0..B−1, not global ids — the candidate
    plan maps them back), take the k smallest keys, and weight by the
    (k+1)-th-key Horvitz–Thompson threshold — the WOR analogue of the
    paper's wᵢ = 1/(B·gᵢ). The degenerate k == B pool (ratio 1) selects
    everything with the exact-mean weights 1/B (πᵢ = 1).

    Returns (idx, g, weights, threshold): pool row indices (int64, race
    order), the full normalised f64 score vector, f32 HT weights, and
    the f64 threshold (+inf when degenerate).
    """
    s = np.asarray(scores, np.float64).reshape(-1)
    B = s.size
    g = s / max(s.sum(), 1e-20)
    k = int(k)
    if k >= B:
        return (np.arange(B, dtype=np.int64), g,
                np.full((B,), 1.0 / max(B, 1), np.float32), float("inf"))
    u = hash_uniform(np.arange(B, dtype=np.int64), ctx)
    r = -np.log(u) / np.maximum(g, 1e-20)
    order = np.lexsort((np.arange(B), r))
    idx = order[:k].astype(np.int64)
    thr = float(r[order[k]])
    return idx, g, ht_weights(g[idx], thr, B), thr


def presample_race_select_raw(scores, k: int, *, ctx: int):
    """Survivor-closed race selection for the survival-pruned scoring
    path (``imp.score_prune="conservative"``).

    Same race as ``presample_race_select`` but on RAW keys rᵢ = Eᵢ/sᵢ —
    no Σs normalisation, because under conservative pruning the losers'
    scores are understated partials and any full-vector reduction (Σs,
    Σg², the exact τ) would read pruned bytes. Scale only multiplies
    every key by the same 1/Σs, so the selected SET (and its order) is
    exactly the normalised race's; every plan quantity is then a
    function of the k+1 smallest keys alone — which conservative pruning
    preserves bit-for-bit:

    * HT inclusion over raw scores: πᵢ = 1 − exp(−sᵢ·τ*), wᵢ = 1/(B·πᵢ)
      (the unnormalised bottom-k sketch — scale cancels inside w·x
      estimators);
    * the Horvitz–Thompson totals Ŝ₁ = Σ_sel sᵢ/πᵢ ≈ Σs and
      Ŝ₂ = Σ_sel sᵢ²/πᵢ ≈ Σs² give the plan's
      τ̂ = sqrt(B·Ŝ₂)/Ŝ₁ — the estimator form of the exact
      τ = sqrt(B·Σg²) (→ 1 uniform, → √B one-hot) — and
      probs_hat = s_sel/Ŝ₁ standing in for g = s/Σs.

    Returns (idx, probs_hat, weights, threshold, tau_hat); probs_hat is
    (k,) — selected rows only, nothing full-vector survives pruning. The
    k ≥ B ratio-1 pool degenerates to the EXACT unpruned quantities
    (nothing is prunable there, every byte is true)."""
    s = np.asarray(scores, np.float64).reshape(-1)
    B = s.size
    k = int(k)
    if k >= B:
        g = s / max(s.sum(), 1e-20)
        tau = float(np.sqrt(B * np.square(g).sum()))
        return (np.arange(B, dtype=np.int64), g,
                np.full((B,), 1.0 / max(B, 1), np.float32), float("inf"),
                tau)
    u = hash_uniform(np.arange(B, dtype=np.int64), ctx)
    r = -np.log(u) / np.maximum(s, 1e-20)
    order = np.lexsort((np.arange(B), r))
    idx = order[:k].astype(np.int64)
    thr = float(r[order[k]])
    pi = np.maximum(-np.expm1(-np.maximum(s[idx], 1e-20) * thr), 1e-300)
    w = (1.0 / (B * pi)).astype(np.float32)
    s1 = max(float((s[idx] / pi).sum()), 1e-20)
    s2 = float((np.square(s[idx]) / pi).sum())
    tau_hat = float(np.sqrt(B * s2) / s1)
    return idx, s[idx] / s1, w, thr, tau_hat
