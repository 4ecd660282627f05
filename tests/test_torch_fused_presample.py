"""The presample pool ops against the JAX package.

* The survival-pruned pool pass: the port's ``pruned_pool_score`` and its
  plain version against the JAX op (interpret mode) and the JAX oracle —
  equal alive masks, equal receipts, survivor scores to rtol 1e-5 — the
  race hash bitwise equal to the reference's, and, inside the port,
  survivors bitwise equal to the unpruned chunked pass.
* The fused presample op (K1 → K2 → K3 → bottom-(k+1) → HT weights →
  gather) and its selection stage: the port's ``fused_presample`` /
  ``select_pool`` (CPU route: the kernels' plain versions) and their
  plain versions ``fused_presample_ref`` / ``select_pool_ref`` against
  JAX's ops in interpret mode, on the reference tests' own cases.
  Indices and gathered rows exact; on identical score bytes probs,
  weights and threshold to 1e-6 relative (Σs is summed in another
  order); scores to rtol 1e-5, atol 1e-6 (direct vs online logsumexp).
  The kernels K2 and K3 are held against their plain versions on the
  card in ``test_torch_pool_kernels.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_presample import ops as jax_ops  # noqa: E402
from repro.kernels.fused_presample import ref as jax_ref  # noqa: E402
from repro.kernels.fused_presample.fused_presample import (  # noqa: E402
    pool_exponentials as jax_pool_exponentials)
from repro.kernels.topk_keys.topk_keys import fmix32 as jax_fmix32  # noqa: E402
from repro.sampler import selection as jax_selection  # noqa: E402
from repro_torch.kernels.fused_presample import race  # noqa: E402
from repro_torch.kernels.fused_presample.ops import (  # noqa: E402
    fused_presample, pruned_pool_score, select_pool)
from repro_torch.kernels.fused_presample.ref import (  # noqa: E402
    fused_presample_ref, pool_exponentials_ref, pruned_pool_score_ref,
    select_pool_ref)
from repro_torch.sampler import selection  # noqa: E402

RTOL = 1e-5
SEL_RTOL = 1e-6   # probs, weights, threshold on identical score bytes


def _pool(B, T, V, seed, pad_frac=0.1, spread=True):
    """A pool whose rows differ in difficulty (so the race kills some)."""
    rng = np.random.default_rng(seed)
    scale = np.linspace(0.2, 4.0, B)[:, None, None] if spread else 2.0
    z = (rng.standard_normal((B, T, V)) * scale).astype(np.float32)
    y = rng.integers(0, V, (B, T)).astype(np.int32)
    y[rng.random((B, T)) < pad_frac] = -1
    return z, y


CASES = [
    # B, T, V, k, chunk/block
    (12, 64, 256, 4, {}),                         # the slice's ratio 3
    (12, 70, 300, 4, dict(block_t=16, chunk_t=16)),  # ragged last chunk
    (20, 48, 200, 5, dict(block_b=4, block_t=8, chunk_t=16)),
    (9, 40, 128, 8, {}),                          # k+1 = B: nothing prunes
]


@pytest.mark.parametrize("B,T,V,k,kw", CASES)
def test_pruned_pool_score_matches_reference(B, T, V, k, kw):
    z, y = _pool(B, T, V, seed=B + T)
    ctx = jax_selection.hash_context(0, 4211, 7)
    s_j, a_j, l_j, st_j = jax_ops.pruned_pool_score(
        jnp.asarray(z), jnp.asarray(y), ctx, k=k, **kw)
    s_r, a_r, l_r, st_r = jax_ref.pruned_pool_score_ref(
        jnp.asarray(z), jnp.asarray(y), ctx, k=k, **kw)
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    s_p, a_p, l_p, st_p = pruned_pool_score(zt, yt, ctx, k=k, **kw)
    s_q, a_q, l_q, st_q = pruned_pool_score_ref(zt, yt, ctx, k=k, **kw)

    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(a_q, np.asarray(a_r))
    np.testing.assert_array_equal(a_p.numpy(), a_q)
    np.testing.assert_array_equal(st_p.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(st_q, np.asarray(st_r))
    live = np.asarray(a_j) > 0
    for got in (s_p.numpy(), s_q):
        np.testing.assert_allclose(got[live], np.asarray(s_j)[live],
                                   rtol=RTOL)
        np.testing.assert_allclose(got[live], np.asarray(s_r)[live],
                                   rtol=RTOL)
    for got in (l_p.numpy(), l_q):
        np.testing.assert_allclose(got[live], np.asarray(l_j)[live],
                                   rtol=RTOL)


def test_pruning_kills_rows_on_the_slice_ratio():
    """The fixture pools are not vacuous: ratio-3 pools lose rows."""
    z, y = _pool(12, 64, 256, seed=76)
    _, alive, _, stats = pruned_pool_score(torch.from_numpy(z),
                                           torch.from_numpy(y), 123, k=4)
    assert float(stats[0]) > 0 and float(stats[1]) > 0
    assert int(alive.sum()) >= 5                   # ≥ k+1 always survive


@pytest.mark.parametrize("ctx", [0, 1, 0xDEADBEEF, 0xFFFFFFFF])
def test_pool_hash_bitwise_vs_reference(ctx):
    n = 1000
    idx = jnp.arange(n, dtype=jnp.uint32)
    h = jax_fmix32(idx * jnp.uint32(0x9E3779B9) ^ jnp.uint32(ctx))
    h = jax_fmix32(h + jnp.uint32(0x6A09E667))
    got = race.pool_hash(n, ctx).numpy()
    np.testing.assert_array_equal(got, np.asarray(h).astype(np.int64))
    # the same uniforms as the host race's hash_uniform, bit for bit
    u = (got >> 8).astype(np.float64) * 2.0 ** -24 + 2.0 ** -25
    np.testing.assert_array_equal(
        u, jax_selection.hash_uniform(np.arange(n), ctx))
    # the exponentials: f32 on both sides, f64 in the oracles
    np.testing.assert_allclose(race.pool_exponentials(n, ctx).numpy(),
                               np.asarray(jax_pool_exponentials(
                                   n, jnp.uint32(ctx))), rtol=1e-6)
    np.testing.assert_array_equal(pool_exponentials_ref(n, ctx),
                                  jax_ref.pool_exponentials_ref(n, ctx))


@pytest.mark.parametrize("B,T,V,k,kw", CASES[:3])
def test_survivors_bitwise_equal_unpruned_chunked_pass(B, T, V, k, kw):
    z, y = _pool(B, T, V, seed=B * T)
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    s, alive, loss, stats = pruned_pool_score(zt, yt, 99, k=k, **kw)
    s0, alive0, loss0, stats0 = pruned_pool_score(zt, yt, 99, k=B, **kw)
    assert bool(alive0.all()) and float(stats0[1]) == 0.0
    live = alive > 0
    assert torch.equal(s[live], s0[live])
    assert torch.equal(loss[live], loss0[live])
    # killed rows carry an understatement of their final score
    assert bool((s[~live] <= s0[~live]).all())


# ---------------------------------------------------------------------------
# the fused presample op and its selection stage
# ---------------------------------------------------------------------------
def _fused_pool(rng, B, T, V, frac_masked=0.2):
    """The reference test's pool: logits, labels (20 % masked), rows."""
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    labels = rng.integers(0, V, size=(B, T))
    labels[rng.random(size=(B, T)) < frac_masked] = -1
    rows = {"tokens": rng.integers(0, V, size=(B, T)).astype(np.int32),
            "labels": labels.astype(np.int32)}
    return logits, labels.astype(np.int32), rows


@pytest.mark.parametrize("B,T,V,k", [
    (24, 8, 64, 8),       # aligned-ish small case
    (37, 13, 97, 8),      # B % block_b != 0 AND V % block_v != 0
    (130, 7, 50, 48),     # B > one row-block with a ragged tail
])
def test_fused_presample_matches_reference(B, T, V, k):
    rng = np.random.default_rng(B + k)
    z, y, rows = _fused_pool(rng, B, T, V)
    ctx = jax_selection.hash_context(123, 4211, 7)
    sel_j, idx_j, w_j, s_j = jax_ops.fused_presample(
        jnp.asarray(z), jnp.asarray(y),
        {n: jnp.asarray(v) for n, v in rows.items()}, ctx, k=k, block_b=16,
        block_v=32)
    trows = {n: torch.from_numpy(v) for n, v in rows.items()}
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    got = fused_presample(zt, yt, trows, ctx, k=k, block_b=16, block_v=32)
    plain = fused_presample_ref(zt, yt, trows, ctx, k=k)
    for sel, idx, w, s in (got, plain):
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        for name in rows:
            np.testing.assert_array_equal(sel[name].numpy(),
                                          np.asarray(sel_j[name]))
            np.testing.assert_array_equal(sel[name].numpy(),
                                          rows[name][idx.numpy()])
        # the weights are float functions of the scores, which differ
        # from JAX's in the last ulps; here that stays within SEL_RTOL
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=SEL_RTOL)
    # on the same CPU tensors the op's plain route and the plain version
    # agree exactly: the same K1/K2 math, top-k vs stable sort
    np.testing.assert_array_equal(got[1].numpy(), plain[1].numpy())
    np.testing.assert_array_equal(got[2].numpy(), plain[2].numpy())


@pytest.mark.parametrize("B,k", [(64, 16), (100, 31), (1024, 256),
                                 (16, 16)])
def test_select_pool_matches_reference_on_identical_scores(B, k):
    """Selection fed the same score bytes as JAX's op: equal indices, and
    probs, weights and threshold to ``SEL_RTOL`` (Σs is summed in another
    order)."""
    rng = np.random.default_rng(3 + B)
    scores = rng.uniform(0.01, 5.0, B).astype(np.float32)
    ctx = jax_selection.hash_context(9, 4211, B)
    want = jax_ops.select_pool(jnp.asarray(scores), ctx, k=k, block_t=32)
    st = torch.from_numpy(scores)
    for got in (select_pool(st, ctx, k=k), select_pool_ref(st, ctx, k=k)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=SEL_RTOL, atol=0)


@pytest.mark.parametrize("ctx", [1234, 0xFFFFFFFF])
def test_select_pool_degenerate_k_equals_B(ctx):
    scores = np.random.default_rng(0).uniform(0.1, 2.0, 12).astype(np.float32)
    want = jax_ops.select_pool(jnp.asarray(scores), ctx, k=12)
    for fn in (select_pool, select_pool_ref):
        idx, g, w, thr = fn(torch.from_numpy(scores), ctx, k=12)
        np.testing.assert_array_equal(idx.numpy(), np.arange(12))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(g.numpy(), np.asarray(want[1]),
                                   rtol=SEL_RTOL)
        np.testing.assert_array_equal(w.numpy(), np.asarray(want[2]))
        assert float(thr) == float(want[3]) == np.inf


def test_select_pool_candidate_set_matches_host_twin():
    """f32 keys (the op) against the host's f64 race (what plans record),
    in the port and in JAX: the selected SET agrees (the K6 f32-vs-f64
    contract); pads (score −1) never win."""
    rng = np.random.default_rng(11)
    for step in range(20):
        B, k = 96, 24
        scores = rng.uniform(0.05, 4.0, B).astype(np.float32)
        ctx = jax_selection.hash_context(5, 4211, step)
        idx, _, _, _ = select_pool(torch.from_numpy(scores), ctx, k=k)
        host, _, _, _ = selection.presample_race_select(scores, k, ctx=ctx)
        jhost, _, _, _ = jax_selection.presample_race_select(scores, k,
                                                             ctx=ctx)
        assert set(idx.tolist()) == set(host.tolist()) == set(jhost.tolist())
    padded = np.concatenate([scores[:90], -np.ones(6, np.float32)])
    idx, _, _, _ = select_pool(torch.from_numpy(padded), 77, k=k)
    assert int(idx.max()) < 90

