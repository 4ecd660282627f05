"""K4, ``ce_score_block``: the port's op and its plain version against the
JAX op (Pallas kernel in interpret mode) and the JAX oracle, on the same
seeded inputs — ragged B, Tc and V, row blocks of 1 and 8, dead blocks,
unsupervised (label −1) tokens. On the CPU the port's op runs its plain
version; the CUDA kernel is held against it on the card (the ``gpu``
case below, and ``chip_smoke.py``). The JAX package loads in a fixture,
so the ``gpu`` case also runs on a card's machine that has no JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ce_score.ops import ce_score, ce_score_block  # noqa: E402
from repro_torch.kernels.ce_score.ref import (ce_score_block_ref,  # noqa: E402
                                              ce_score_ref)

RTOL = 1e-5      # f32 row sums; direct vs online softmax differ in ulps
ATOL = 1e-5      # for sums that cancel to ~0 (dead rows are exact zeros)


def _inputs(B, Tc, V, *, seed, dead=(), pad_frac=0.2):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((B, Tc, V)) * 2.0).astype(np.float32)
    y = rng.integers(0, V, (B, Tc)).astype(np.int32)
    y[rng.random((B, Tc)) < pad_frac] = -1
    alive = np.ones((B,), np.float32)
    alive[list(dead)] = 0.0
    return z, y, alive


@pytest.fixture(scope="module")
def jax_k4():
    """(jax.numpy, the JAX op module, the JAX oracle module)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ce_score import ops, ref
    return jnp, ops, ref


CASES = [
    # B, Tc, V, block_b, dead rows
    (8, 16, 128, 1, ()),
    (8, 16, 128, 8, ()),
    (7, 13, 100, 1, (2, 5)),          # ragged everywhere, dead rows
    (12, 9, 2100, 8, (8, 9, 10, 11)),  # a fully dead 8-block's tail
    (17, 5, 333, 8, range(8, 16)),    # one whole dead block of 8
    (3, 1, 50, 8, (1,)),              # single token, half-dead block
]


@pytest.mark.parametrize("B,Tc,V,bb,dead", CASES)
def test_ce_score_block_matches_reference(jax_k4, B, Tc, V, bb, dead):
    jnp, jax_ops, jax_ref = jax_k4
    z, y, alive = _inputs(B, Tc, V, seed=B * Tc + V, dead=dead)
    want_op = jax_ops.ce_score_block(jnp.asarray(z), jnp.asarray(y),
                                     jnp.asarray(alive), block_b=bb,
                                     block_t=8, block_v=128)
    want_ref = jax_ref.ce_score_block_ref(jnp.asarray(z), jnp.asarray(y),
                                          jnp.asarray(alive), block_b=bb)
    zt, yt, at = map(torch.from_numpy, (z, y, alive))
    got_op = ce_score_block(zt, yt, at, block_b=bb)
    got_ref = ce_score_block_ref(zt, yt, at, block_b=bb)
    for got in (got_op, got_ref):
        for g, w_op, w_ref in zip(got, want_op, want_ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_op),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(w_ref),
                                       rtol=RTOL, atol=ATOL)


def test_ce_score_ref_matches_reference(jax_k4):
    jnp, _, jax_ref = jax_k4
    rng = np.random.default_rng(1)
    z = (rng.standard_normal((40, 700)) * 3).astype(np.float32)
    y = rng.integers(0, 700, (40,)).astype(np.int32)
    ce_j, g2_j = jax_ref.ce_score_ref(jnp.asarray(z), jnp.asarray(y))
    ce_p, g2_p = ce_score_ref(torch.from_numpy(z), torch.from_numpy(y))
    np.testing.assert_allclose(ce_p.numpy(), np.asarray(ce_j), rtol=RTOL)
    np.testing.assert_allclose(g2_p.numpy(), np.asarray(g2_j), rtol=RTOL)


K1_CASES = [
    # T, V, block_t, block_v (tests/test_kernels.py's tiles)
    (16, 128, 8, 128),       # exact tiles
    (13, 100, 8, 64),        # padding in both dims
    (32, 1000, 16, 256),     # many vocab tiles
    (1, 50, 8, 128),         # single token, one tile bigger than the data
    (19, 129, 8, 128),       # both ragged, vocab pad of 127
    (130, 1000, 64, 512),    # both ragged, larger tiles
]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("T,V,bt,bv", K1_CASES)
def test_ce_score_matches_reference(jax_k4, T, V, bt, bv, dtype, tol):
    """K1 against the JAX op and oracle; labels forced onto column 0, the
    last column and the first column of the last vocab tile."""
    jnp, jax_ops, jax_ref = jax_k4
    rng = np.random.RandomState(T * V)
    z = (rng.randn(T, V) * 3).astype(np.float32)
    y = rng.randint(0, V, (T,)).astype(np.int32)
    y[0], y[1 % T], y[2 % T] = V - 1, (V // bv) * min(bv, V) % V, 0
    jz = jnp.asarray(z).astype(getattr(jnp, dtype))
    want_op = jax_ops.ce_score(jz, jnp.asarray(y), block_t=bt, block_v=bv)
    want_ref = jax_ref.ce_score_ref(jz.astype(jnp.float32), jnp.asarray(y))
    zt = torch.from_numpy(z).to(getattr(torch, dtype))
    yt = torch.from_numpy(y)
    got_op = ce_score(zt, yt, block_t=bt, block_v=bv)
    got_ref = ce_score_ref(zt.float(), yt)
    for g, r in zip(got_ref, want_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)
    for g, w_op, w_ref in zip(got_op, want_op, want_ref):
        assert g.dtype == torch.float32 and g.shape == (T,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_op), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_ref), rtol=tol,
                                   atol=tol)


def test_ce_score_extreme_logits_stable(jax_k4):
    jnp, jax_ops, _ = jax_k4
    z = np.asarray([[1e4, -1e4, 0.0, 5.0]] * 3, np.float32)
    y = np.asarray([0, 1, 2], np.int32)
    ce, g2 = ce_score(torch.from_numpy(z), torch.from_numpy(y))
    assert bool(torch.isfinite(ce).all()) and bool(torch.isfinite(g2).all())
    # label = argmax -> ce ~ 0, g2 ~ 0; label = argmin -> g2 ~ 2
    assert float(ce[0]) == pytest.approx(0.0, abs=1e-3)
    assert float(g2[0]) == pytest.approx(0.0, abs=1e-3)
    assert float(g2[1]) == pytest.approx(2.0, abs=1e-3)
    want = jax_ops.ce_score(jnp.asarray(z), jnp.asarray(y), block_t=8,
                            block_v=128)
    for g, w in zip((ce, g2), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-3)


def test_ce_score_batched_shapes(jax_k4):
    """Leading dims flatten to tokens and come back."""
    jnp, jax_ops, _ = jax_k4
    rng = np.random.RandomState(0)
    z = rng.randn(2, 5, 64).astype(np.float32)
    y = rng.randint(0, 64, (2, 5)).astype(np.int32)
    ce, g2 = ce_score(torch.from_numpy(z), torch.from_numpy(y))
    assert ce.shape == (2, 5) and g2.shape == (2, 5)
    want = jax_ops.ce_score(jnp.asarray(z), jnp.asarray(y))
    for g, w in zip((ce, g2), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_ce_score_refuses_gradients():
    """K1 has no gradient, as the Pallas kernel has no VJP."""
    z = torch.randn(3, 7, requires_grad=True)
    y = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        ce_score(z, y)
    with torch.no_grad():
        ce, _ = ce_score(z, y)
    assert ce.shape == (3,)


def test_freeze_semantics_bitwise():
    """Dead row blocks emit exactly 0.0 and killing a block leaves every
    other row's bytes untouched; a half-dead block still computes."""
    z, y, _ = _inputs(8, 12, 64, seed=3)
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    full = ce_score_block(zt, yt, torch.ones(8), block_b=2)
    alive = torch.tensor([1, 1, 0, 0, 1, 0, 1, 1], dtype=torch.float32)
    part = ce_score_block(zt, yt, alive, block_b=2)
    for f, p in zip(full, part):
        assert p[2:4].tolist() == [0.0, 0.0]
        live = [0, 1, 4, 5, 6, 7]
        assert torch.equal(p[live], f[live])


def test_plain_route_is_chosen_by_device_or_interpret():
    """CPU tensors take the plain version whatever ``interpret`` says;
    ``interpret=True`` is the only other way there."""
    z, y, alive = map(torch.from_numpy, _inputs(4, 6, 50, seed=2))
    want = ce_score_block_ref(z, y, alive, block_b=8)
    for interp in (None, False, True):
        got = ce_score_block(z, y, alive, interpret=interp)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (the kernel is sm_90a CUDA)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_matches_plain_on_gpu(cuda, dtype):
    """The CUDA kernel against its plain version on the card: a strided
    time-chunk view, ragged V and Tc, dead blocks, label −1."""
    from repro_torch.kernels.ce_score import ce_score as k4
    z, y, alive = _inputs(12, 40, 1003, seed=11, dead=range(8, 12))
    zt = torch.from_numpy(z).to(cuda, getattr(torch, dtype))
    yt = torch.from_numpy(y).to(cuda)
    at = torch.from_numpy(alive).to(cuda)
    view = (zt[:, 3:28], yt[:, 3:28])            # strided, like a chunk
    before = k4.launches
    got = ce_score_block(*view, at, block_b=8)
    assert k4.launches == before + 1
    want = ce_score_block_ref(*view, at, block_b=8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 1e-4), ("float32", 1e-4)])
def test_k1_kernel_matches_plain_on_gpu(cuda, dtype, tol):
    """K1 against its plain version on the card, on the same (rounded)
    logits: ragged T and V, labels at 0 and V − 1, a strided row view,
    extreme logits."""
    from repro_torch.kernels.ce_score import ce_score as kern
    rng = np.random.default_rng(4)
    T, V = 37, 50257
    z = (rng.standard_normal((T, V + 3)) * 3).astype(np.float32)
    z[5, :4] = [1e4, -1e4, 0.0, 5.0]
    y = rng.integers(0, V, (T,)).astype(np.int32)
    y[0], y[1], y[5] = 0, V - 1, 0
    zt = torch.from_numpy(z).to(cuda, getattr(torch, dtype))[:, 1:V + 1]
    yt = torch.from_numpy(y).to(cuda)
    before = kern.ce_score_launches
    got = ce_score(zt, yt)
    assert kern.ce_score_launches == before + 1
    want = ce_score_ref(zt, yt)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)
