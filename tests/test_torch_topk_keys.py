"""K6, ``topk_race_keys``: the port's op (CPU route) and its plain version
against the JAX op (Pallas kernel in interpret mode) and the JAX oracle
on the same seeded shards — ragged n, several ``block_t``, unseen and
padded lanes, T ∈ {1, 0.5}, a 3-host shard. Keys agree to 1e-6
relative (float32 log/exp ulps), the returned slots and their order
exactly. The hashed uniforms are bitwise the reference's
``selection.hash_uniform``. The CUDA kernel is held against the plain
version on the card (the ``gpu`` case, and ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_presample.race import race_uniforms  # noqa: E402
from repro_torch.kernels.topk_keys.ops import (race_keys,  # noqa: E402
                                               topk_race_keys)
from repro_torch.kernels.topk_keys.ref import (race_keys_ref,  # noqa: E402
                                               topk_race_keys_ref)
from repro_torch.sampler import selection  # noqa: E402

RTOL = 1e-6


@pytest.fixture(scope="module")
def jax_k6():
    """(jax.numpy, the JAX op, the JAX oracle, the JAX selection module)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.topk_keys.ops import topk_race_keys as jop
    from repro.kernels.topk_keys.ref import topk_race_keys_ref as jref
    from repro.sampler import selection as jsel
    return jnp, jop, jref, jsel


def _shard(n, seed, *, pad=0):
    """Scores and seen flags (1 seen, 0 unseen, −1 on the last ``pad``
    lanes) of a seeded shard."""
    rng = np.random.default_rng(seed)
    sc = rng.lognormal(0.0, 1.0, n).astype(np.float32)
    seen = (rng.random(n) < 0.7).astype(np.float32)
    if pad:
        seen[n - pad:] = -1.0
    return sc, seen


CASES = [
    # n, block_t, host_id, n_hosts, temperature, padded lanes
    (1, 8, 0, 1, 1.0, 0),
    (7, 8, 0, 1, 0.5, 0),
    (7, 4, 1, 3, 1.0, 2),
    (1000, 256, 1, 3, 0.5, 0),
    (1000, 1024, 0, 1, 1.0, 24),
    (4099, 512, 1, 3, 0.5, 3),
    (4099, 1024, 0, 1, 1.0, 0),
]


@pytest.mark.parametrize("n,bt,h,H,temp,pad", CASES)
def test_topk_race_keys_matches_reference(jax_k6, n, bt, h, H, temp, pad):
    jnp, jop, jref, jsel = jax_k6
    sc, seen = _shard(n, seed=n + bt + pad, pad=pad)
    stats = jsel.shard_stats(sc, (seen > 0), temp)
    dist = jsel.GlobalDist(stats, n * H, 0.1, temp)
    ctx = jsel.hash_context(3, 9173, n)
    k = min(16, n - pad)
    kw = dict(k=k, host_id=h, n_hosts=H, n_global=dist.n, smoothing=0.1,
              inv_temp=dist.inv_t, block_t=bt)
    jk, js = jop(jnp.asarray(sc), jnp.asarray(seen), np.uint32(ctx),
                 dist.fill_pow, dist.total, **kw)
    pk, ps = topk_race_keys(torch.from_numpy(sc), torch.from_numpy(seen), ctx,
                            dist.fill_pow, dist.total, **kw)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=RTOL)
    # the plain key vector against the JAX oracle, padded lanes aside
    gids = np.arange(n, dtype=np.uint32) * H + h
    okw = dict(fill_pow=dist.fill_pow, total=dist.total, n_global=dist.n,
               smoothing=0.1, inv_temp=dist.inv_t)
    want = np.asarray(jref(sc, seen, gids, ctx, **okw))
    got = topk_race_keys_ref(torch.from_numpy(sc), torch.from_numpy(seen),
                             torch.from_numpy(gids.astype(np.int64)), ctx,
                             **okw).numpy()
    live = seen >= 0
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL)
    # the op's full key vector: the plain version's bytes, +inf on pads
    kkw = {k: v for k, v in kw.items() if k not in ("k", "block_t")}
    keys = race_keys(torch.from_numpy(sc), torch.from_numpy(seen), ctx,
                     dist.fill_pow, dist.total, **kkw)
    assert torch.equal(keys, race_keys_ref(
        torch.from_numpy(sc), torch.from_numpy(seen), ctx, dist.fill_pow,
        dist.total, **kkw))
    np.testing.assert_allclose(keys.numpy()[live], want[live], rtol=RTOL)
    assert np.isinf(keys.numpy()[~live]).all()
    # padded lanes never win, and interpret=True is the same route on CPU
    assert not np.isin(ps.numpy(), np.flatnonzero(~live)).any()
    assert np.isfinite(pk.numpy()).all()
    pk2, ps2 = topk_race_keys(torch.from_numpy(sc), torch.from_numpy(seen),
                              ctx, dist.fill_pow, dist.total, interpret=True,
                              **kw)
    assert torch.equal(ps2, ps) and torch.equal(pk2, pk)


def test_ties_go_to_the_lower_slot():
    """Equal keys rank by slot, as ``lax.top_k`` of the negated keys does:
    with n_hosts = 2³¹ the uint32 ids wrap to two values (even slots 0,
    odd slots 2³¹), so equal scores give two runs of tied keys."""
    n = 64
    keys, slots = topk_race_keys(torch.ones(n), torch.ones(n), 5, 1.0,
                                 float(n), k=n, n_hosts=2 ** 31,
                                 n_global=n, smoothing=0.0)
    assert len(set(keys.tolist())) == 2
    first = slots[0].item() % 2
    want = [*range(first, n, 2), *range(1 - first, n, 2)]
    assert slots.tolist() == want
    assert (np.diff(keys.numpy()) >= 0).all()


@pytest.mark.parametrize("ctx", [0, 12345, 0xFFFFFFFF])
def test_race_uniforms_bitwise_vs_host_hash(jax_k6, ctx):
    """The port's hashed uniforms are the reference's ``hash_uniform``
    rounded to f32, bit for bit (ids below 2³²), and the port's numpy
    copy of ``hash_uniform`` is bitwise the reference's."""
    _, _, _, jsel = jax_k6
    gids = np.concatenate([np.arange(4096), [2 ** 31 + 5, 2 ** 32 - 1]])
    want = jsel.hash_uniform(gids, ctx)
    np.testing.assert_array_equal(selection.hash_uniform(gids, ctx), want)
    got = race_uniforms(torch.from_numpy(gids), ctx).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU (the kernel is sm_90a CUDA)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu(cuda):
    """The CUDA kernel against its plain version on the card: a ragged
    3-host shard with unseen and padded lanes, T = 0.5."""
    from repro_torch.kernels.topk_keys import topk_keys as k6
    sc, seen = _shard(70001, seed=4, pad=5)
    stats = selection.shard_stats(sc, seen > 0, 0.5)
    dist = selection.GlobalDist(stats, 3 * 70001, 0.1, 0.5)
    kw = dict(k=33, host_id=2, n_hosts=3, n_global=dist.n, smoothing=0.1,
              inv_temp=dist.inv_t)
    args = (selection.hash_context(1, 9173, 7), dist.fill_pow, dist.total)
    before = k6.launches
    gk, gs = topk_race_keys(torch.from_numpy(sc).to(cuda),
                            torch.from_numpy(seen).to(cuda), *args, **kw)
    assert k6.launches == before + 1
    pk, ps = topk_race_keys(torch.from_numpy(sc), torch.from_numpy(seen),
                            *args, **kw)
    torch.testing.assert_close(gk.cpu(), pk, rtol=2 * RTOL, atol=0)
    assert torch.equal(gs.cpu(), ps)
    kkw = {k: v for k, v in kw.items() if k != "k"}
    on_card = race_keys(torch.from_numpy(sc).to(cuda),
                        torch.from_numpy(seen).to(cuda), *args, **kkw)
    plain = race_keys_ref(torch.from_numpy(sc).to(cuda),
                          torch.from_numpy(seen).to(cuda), *args, **kkw)
    torch.testing.assert_close(on_card, plain, rtol=2 * RTOL, atol=0)
