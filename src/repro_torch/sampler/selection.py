"""Selection math: the numpy functions of ``repro.sampler.selection``,
copied so the port's plans stay bitwise equal to the reference's.

* **Counter-based race keys.** Every (plan, pool row) gets a uniform
  ``u ∈ (0,1)`` from a pure integer hash, giving the exponential race key
  ``r_i = E_i / p_i`` with ``E_i = −log u_i``; the k smallest keys are a
  probability-proportional-to-``p`` sample without replacement.
* **Unbiasedness via the race threshold.** Conditioned on the (k+1)-th
  smallest key τ*, each selected row was included with probability
  ``π_i = 1 − exp(−p_i·τ*)``; the Horvitz–Thompson weights
  ``w_i = 1/(n·π_i)`` keep the weighted-mean estimator unbiased.

* **Sharded O(b) store selection** (``history``/``selective`` under
  ``imp.selection_impl="sharded"``). Each host keys only its own
  ``ScoreStore`` shard and takes a local bottom-(k+1); the hosts exchange
  those ``(k+1)·H`` candidates (``collectives.exchange_topk``) and run one
  deterministic merge. The smoothed distribution
  ``p_i = (1−λ)·s̃_i/S̃ + λ/n`` needs only four reduced per-shard scalars
  (``shard_stats`` → ``GlobalDist``), so the τ gate, the normalizer and
  the decay attractor never read the full vector. The per-shard key-gen +
  bottom-k hot loop runs on the card as K6
  (``repro_torch.kernels.topk_keys``, ``local_candidates_kernel``).
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.distributed import collectives

EPS = 1e-12          # the distribution_from score clamp, shared here
_PAD_GID = -1        # candidate-block padding (filtered by the merges)

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


# ---------------------------------------------------------------------------
# sufficient statistics → the global smoothed distribution, closed form
# ---------------------------------------------------------------------------
def shard_stats(scores, seen, temperature: float = 1.0) -> np.ndarray:
    """This shard's contribution to the global distribution: the float64
    4-vector [Σs_seen, #seen, Σs̃, Σs̃²] with s̃ = max(s, EPS)^(1/T) over
    seen slots. Σ across hosts is all the state ``GlobalDist`` needs."""
    m = np.asarray(seen) != 0
    s = np.where(m, np.asarray(scores, np.float64), 0.0)
    sp = np.maximum(s, EPS)
    if temperature != 1.0:
        sp = sp ** (1.0 / temperature)
    sp = np.where(m, sp, 0.0)       # unseen slots carry no mass
    return np.array([s.sum(), float(m.sum()), sp.sum(),
                     np.square(sp).sum()], np.float64)


class GlobalDist:
    """The global selection distribution, derived from reduced stats.

    Matches ``ScoreStore.distribution_from`` (fill unseen with the seen
    mean, clamp, sharpen by 1/T, normalize, mix λ with uniform) without
    materialising the vector: per-id probabilities come from the id's own
    shard score plus the reduced scalars; τ and coverage are closed
    forms of the same scalars."""

    def __init__(self, stats, n: int, smoothing: float = 0.1,
                 temperature: float = 1.0):
        sum_raw, n_seen, sum_pow, sumsq_pow = np.asarray(stats, np.float64)
        self.n = int(n)
        self.lam = float(smoothing)
        self.inv_t = 1.0 / float(temperature)
        self.n_seen = int(round(float(n_seen)))
        fill = (float(sum_raw) / self.n_seen) if self.n_seen else 1.0
        self.fill_pow = max(fill, EPS) ** self.inv_t
        n_unseen = self.n - self.n_seen
        # S̃ = Σ s̃ with unseen slots carrying the fill mass
        self.total = float(sum_pow) + n_unseen * self.fill_pow
        self.total_sq = float(sumsq_pow) + n_unseen * self.fill_pow ** 2

    @property
    def coverage(self) -> float:
        return self.n_seen / self.n if self.n else 0.0

    def tau(self) -> float:
        """τ² = n·Σp² over the mixture:
        n(1−λ)²·Σs̃²/S̃² + 2(1−λ)λ + λ²."""
        lam = self.lam
        q = self.total_sq / (self.total ** 2) if self.total > 0 else 0.0
        return float(np.sqrt(self.n * (1.0 - lam) ** 2 * q
                             + 2.0 * (1.0 - lam) * lam + lam ** 2))

    def probs(self, scores, seen) -> np.ndarray:
        """p_i for arbitrary ids given their raw shard scores."""
        m = np.asarray(seen).astype(bool)
        sp = np.maximum(np.asarray(scores, np.float64), EPS)
        if self.inv_t != 1.0:
            sp = sp ** self.inv_t
        sp = np.where(m, sp, self.fill_pow)
        return (1.0 - self.lam) * sp / self.total + self.lam / self.n


# ---------------------------------------------------------------------------
# proportional sampling: local bottom-(k+1) → exchange → merge + HT weights
# ---------------------------------------------------------------------------
def _candidate_block(kc: int) -> dict:
    return {"gid": np.full((kc,), _PAD_GID, np.int64),
            "key": np.full((kc,), np.inf, np.float64),
            "prob": np.zeros((kc,), np.float64)}


def local_candidates(scores, seen, gids, dist: GlobalDist, kc: int, *,
                     ctx: int) -> dict:
    """This shard's kc best proposal candidates: exponential race keys
    r = −log(u)/p over the shard, bottom-kc by (key, gid), padded to kc
    rows (gid −1 / key +inf) for a fixed-shape exchange. The float64
    host loop; K6 is its device twin (``local_candidates_kernel``)."""
    gids = np.asarray(gids, np.int64)
    p = dist.probs(scores, seen)
    r = -np.log(hash_uniform(gids, ctx)) / p
    k = min(int(kc), r.size)
    idx = np.argpartition(r, k - 1)[:k] if r.size > k else np.arange(r.size)
    order = np.lexsort((gids[idx], r[idx]))
    idx = idx[order]
    out = _candidate_block(int(kc))
    out["gid"][:k], out["key"][:k], out["prob"][:k] = gids[idx], r[idx], p[idx]
    return out


def local_candidates_kernel(store, dist: GlobalDist, kc: int, *, ctx: int,
                            device, block_t: int = 1024,
                            timing=None) -> dict:
    """``local_candidates`` through K6 on ``device``: the shard's scores
    and seen flags move to the device, the race keys and their bottom-kc
    are computed there (``kernels.topk_keys.ops.topk_race_keys``), and
    only the kc winners come back, their probabilities recomputed in
    float64. Keys are float32 here: candidate sets agree with the host
    loop, key bytes do not, so a run picks ONE path for every host
    (``sample_sharded(use_kernel=...)``).

    ``timing``, a dict, receives the CUDA-event times of the phases on a
    CUDA device (``h2d_ms``, ``k6_ms``, ``topk_ms``)."""
    import torch

    from repro_torch.kernels.topk_keys.ops import topk_race_keys
    device = torch.device(device)
    marks = [] if timing is not None and device.type == "cuda" else None
    obs.device_mark(marks)
    scores = torch.from_numpy(store.scores).to(device)
    seen = torch.from_numpy(store.seen.astype(np.float32)).to(device)
    obs.device_mark(marks)
    kk = min(int(kc), store.n_local)
    keys, slots = topk_race_keys(
        scores, seen, ctx, dist.fill_pow, dist.total, k=kk,
        host_id=store.host_id, n_hosts=store.n_hosts, n_global=dist.n,
        smoothing=dist.lam, inv_temp=dist.inv_t, block_t=block_t,
        marks=marks)
    keys = keys.cpu().numpy().astype(np.float64)
    slots = slots.cpu().numpy().astype(np.int64)
    if marks:
        timing.update(zip(("h2d_ms", "k6_ms", "topk_ms"),
                          obs.mark_intervals_ms(marks)))
    gids = store.global_ids(slots)
    order = np.lexsort((gids, keys))
    out = _candidate_block(int(kc))
    out["gid"][:kk] = gids[order]
    out["key"][:kk] = keys[order]
    out["prob"][:kk] = dist.probs(store.scores[slots[order]],
                                  store.seen[slots[order]])
    return out


def merge_topk(cand: dict, k: int):
    """Deterministic global merge of the exchanged candidate blocks: the
    k smallest race keys win (ties broken by gid), and the (k+1)-th key
    is the Horvitz–Thompson threshold τ*."""
    gid = np.asarray(cand["gid"], np.int64)
    valid = gid >= 0
    gid, key, prob = (gid[valid], np.asarray(cand["key"], np.float64)[valid],
                      np.asarray(cand["prob"], np.float64)[valid])
    if gid.size <= k:
        raise ValueError(f"{gid.size} candidates for top-{k} — the HT "
                         f"threshold needs k+1 (dataset must have n > k)")
    order = np.lexsort((gid, key))
    sel = order[:k]
    return gid[sel], prob[sel], float(key[order[k]])


def resolve_selection_impl(impl: str, *, n: int, b: int,
                           n_hosts: int) -> str:
    """Resolve ``imp.selection_impl="auto"`` from the reference's measured
    crossover: gather at one host (the gather is an identity there) and
    at small n/H, sharded once n ≳ 24·b·H. "gather"/"sharded" force
    either path."""
    if impl != "auto":
        return impl
    if n_hosts <= 1:
        return "gather"
    return "sharded" if n >= 24 * b * n_hosts else "gather"


def sample_sharded(store, dist: GlobalDist, k: int, *, seed: int, salt: int,
                   step: int, n_hosts: int = 1, use_kernel=None, device=None,
                   timing=None):
    """Draw k global ids ∝ ``dist`` across host-sharded stores.

    Each host keys only its own shard; ``collectives.exchange_topk``
    carries the (k+1)-per-host candidate blocks; the merge and weights
    are pure functions of the exchanged bytes. ``use_kernel=None`` runs
    the key-gen + bottom-k on K6 when ``device`` is a CUDA device and the
    float64 numpy loop otherwise; ``use_kernel=True`` on a CPU ``device``
    takes K6's plain torch version. ``timing`` (a dict) receives the
    kernel path's phase times. Returns (gids, probs, weights, threshold)."""
    import torch
    device = torch.device("cpu" if device is None else device)
    ctx = hash_context(seed, salt, step)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    # the kernel hard-codes strided gid arithmetic
    if use_kernel and store.ownership.kind == "strided":
        block = local_candidates_kernel(store, dist, k + 1, ctx=ctx,
                                        device=device, timing=timing)
    else:
        block = local_candidates(store.scores, store.seen,
                                 store.global_ids(np.arange(store.n_local)),
                                 dist, k + 1, ctx=ctx)
    cand = collectives.exchange_topk(block, k_each=k + 1, n_hosts=n_hosts)
    gids, probs, thr = merge_topk(cand, k)
    return gids, probs, ht_weights(probs, thr, store.n), thr


# ---------------------------------------------------------------------------
# selective backprop: sharded global top-b ranking of a candidate window
# ---------------------------------------------------------------------------
def local_rank_candidates(pool, store, k: int) -> dict:
    """This host's k best rows of the selective window: priority = stored
    score (never-seen → +inf), ties broken by pool position — the gather
    path's stable argsort, so the merged top-k is bitwise equal to it."""
    pool = np.asarray(pool, np.int64)
    pos = np.flatnonzero(store.owned(pool))
    slots = store.slot(pool[pos])
    pri = np.where(store.seen[slots].astype(bool),
                   store.scores[slots].astype(np.float64), np.inf)
    take = np.lexsort((pos, -pri))[:min(int(k), pos.size)]
    out = {"pos": np.full((int(k),), _PAD_GID, np.int64),
           "pri": np.full((int(k),), -np.inf, np.float64)}
    out["pos"][:take.size] = pos[take]
    out["pri"][:take.size] = pri[take]
    return out


def merge_rank(cand: dict, k: int) -> np.ndarray:
    """Global top-k pool positions by (priority desc, pool position)."""
    pos = np.asarray(cand["pos"], np.int64)
    valid = pos >= 0
    pos, pri = pos[valid], np.asarray(cand["pri"], np.float64)[valid]
    order = np.lexsort((pos, -pri))[:k]
    return pos[order]
