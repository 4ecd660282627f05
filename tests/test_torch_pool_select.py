"""The pool selection (row scores → Σs → race keys → bottom-(k+1) → HT
weights) against the JAX package, on the CPU.

The port's plain version ``pool_select_plain``, the function one
``pool_select`` launch computes on the card, is held against the
reference's own stages on the same seeded numpy inputs: the TPU kernels
``row_score_pallas`` and ``pool_keys_pallas`` in interpret mode, then the
reference's ``_select_pool``. The kernel itself is held against
``pool_select_plain`` on the card in ``test_torch_pool_kernels.py`` and
``chip_smoke.py``.

Tolerances: scores to 1e-6 relative (f32 sums over 24 tokens in another
order). Keys to ``K6_RTOL``, not bitwise: both sides are fed the port's
1/Σs, but each computes log(u) with its own f32 log and scales its own
scores, which may differ in the last ulp. Indices equal; probs, weights
and threshold to 1e-6 relative (Σs summed in another order)."""
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_presample import ops as jax_ops  # noqa: E402
from repro.kernels.fused_presample.fused_presample import (  # noqa: E402
    pool_keys_pallas, row_score_pallas)
from repro_torch.kernels.fused_presample import (  # noqa: E402
    fused_presample as fp)
from repro_torch.kernels.fused_presample.ops import (  # noqa: E402
    fused_presample, select_pool)

SCORE_RTOL = 1e-6
K6_RTOL = 2e-6
SEL_RTOL = 1e-6
T = 24


@functools.lru_cache(maxsize=None)
def _inputs(B):
    rng = np.random.default_rng(B)
    g2 = rng.uniform(0.0, 2.0, (B, T)).astype(np.float32)
    return g2, rng.random((B, T)) >= 0.2


@functools.lru_cache(maxsize=None)
def _jax_scores(B):
    g2, mask = _inputs(B)
    return np.asarray(row_score_pallas(jnp.asarray(g2), jnp.asarray(mask),
                                       interpret=True))


def _jax_select(s, ctx, k, inv_total):
    """The reference's keys (fed ``inv_total``) and ``_select_pool``."""
    keys = pool_keys_pallas(jnp.asarray(s), jnp.asarray(
        np.array([ctx], np.uint32)), jnp.asarray(inv_total), interpret=True)
    out = jax_ops._select_pool(jnp.asarray(s), jax_ops._ctx_u32(ctx), k=k)
    return (np.asarray(keys), *map(np.asarray, out))


def _check(port, s_ref, ctx, k):
    s, inv_total, keys, idx, probs, w, thr = port
    keys_j, idx_j, probs_j, w_j, thr_j = _jax_select(s_ref, ctx, k,
                                                     inv_total.numpy())
    np.testing.assert_allclose(keys.numpy(), keys_j, rtol=K6_RTOL, atol=0)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    for got, want in ((probs, probs_j), (w, w_j), (thr, thr_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=SEL_RTOL, atol=0)


@pytest.mark.parametrize("ctx", [0, 0xFFFFFFFF])
@pytest.mark.parametrize("kk", ["1", "B/4", "B-1", "B"])
@pytest.mark.parametrize("B", [12, 100, 768, 1000])
def test_pool_select_plain_matches_reference(B, kk, ctx):
    k = {"1": 1, "B/4": B // 4, "B-1": B - 1, "B": B}[kk]
    g2, mask = _inputs(B)
    port = fp.pool_select_plain(torch.from_numpy(g2), torch.from_numpy(mask),
                                ctx, k)
    s_ref = _jax_scores(B)
    np.testing.assert_allclose(port[0].numpy(), s_ref, rtol=SCORE_RTOL,
                               atol=0)
    assert port[3].shape == (min(k, B),) and port[6].shape == ()
    _check(port, s_ref, ctx, k)


def test_pool_select_pad_lanes_tie_to_the_lower_row():
    """70 of 100 rows are −1 pads and k + 1 = 51 exceeds the 30 live rows:
    21 winners have key +inf, and among those the lower rows win, in
    ascending row order, as ``lax.top_k`` orders ties."""
    B, k, ctx = 100, 50, 4211
    rng = np.random.default_rng(7)
    s = rng.uniform(5.0, 10.0, B).astype(np.float32)
    pads = np.sort(rng.permutation(B)[:70])
    s[pads] = -1.0
    live = B - len(pads)
    port = fp.pool_select_scores_plain(torch.from_numpy(s), ctx, k)
    _check(port, s, ctx, k)
    idx, thr = port[3].numpy(), float(port[6])
    assert thr == np.inf
    assert set(idx[:live]) == set(np.flatnonzero(s >= 0))
    np.testing.assert_array_equal(idx[live:], pads[:k - live])
    np.testing.assert_array_equal(port[2].numpy()[pads], np.inf)


def test_ops_route_cpu_tensors_to_the_plain_version():
    """On CPU tensors the ops never reach the kernel: its count stays, and
    ``select_pool`` returns ``pool_select_scores_plain``'s selection."""
    g2, mask = _inputs(12)
    s = fp.row_score_math(torch.from_numpy(g2), torch.from_numpy(mask))
    before = fp.pool_select_launches
    got = select_pool(s, 99, k=4)
    want = fp.pool_select_scores_plain(s, 99, 4)[3:]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (12, 8, 40)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(2).integers(
        -1, 40, (12, 8)).astype(np.int32))
    fused_presample(z, y, {"labels": y}, 99, k=4)
    assert fp.pool_select_launches == before


def test_pool_select_cuda_refuses_what_the_kernel_does_not_take():
    """The wrappers raise on CPU tensors and wrong shapes or types before
    anything is built: no plain fallback."""
    g2, mask = map(torch.from_numpy, _inputs(12))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fp.pool_select_cuda(g2, mask, 0, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fp.pool_select_scores_cuda(g2[:, 0].contiguous(), 0, 4)
    with pytest.raises(ValueError, match=r"\(B, T\)"):
        fp.pool_select_cuda(g2[0], mask[0], 0, 4)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        fp.pool_select_scores_cuda(g2, 0, 4)


def test_wrapper_scratch_threshold_is_the_kernels():
    """The wrapper allocates the winners' scratch exactly when the kernel
    sorts outside shared memory: one constant on both sides."""
    src = fp.SOURCES[0].read_text()
    found = re.search(r"kSmemWin = (\d+);", src)
    assert found and int(found.group(1)) == fp.SMEM_WINNERS
