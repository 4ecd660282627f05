"""The survival-pruned pool pass: the port's ``pruned_pool_score`` and its
plain version against the JAX op (interpret mode) and the JAX oracle —
equal alive masks, equal receipts, survivor scores to rtol 1e-5 — the
race hash bitwise equal to the reference's, and, inside the port,
survivors bitwise equal to the unpruned chunked pass."""
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
    pruned_pool_score)
from repro_torch.kernels.fused_presample.ref import (  # noqa: E402
    pool_exponentials_ref, pruned_pool_score_ref)

RTOL = 1e-5


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
