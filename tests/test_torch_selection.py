"""The port's copy of the presample selection math is bitwise the
reference's (``repro.sampler.selection``) on seeded inputs."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.sampler import selection as ref  # noqa: E402
from repro_torch.sampler import selection as port  # noqa: E402


def _scores(seed, B):
    rng = np.random.default_rng(seed)
    s = rng.gamma(2.0, 1.0, B).astype(np.float32)
    s[rng.random(B) < 0.1] = 0.0                  # zero-score rows
    return s


@pytest.mark.parametrize("seed,salt,step", [(0, 4211, 0), (7, 4211, 12345),
                                            (2 ** 40 + 3, 9173, 2 ** 31)])
def test_hash_context_bitwise(seed, salt, step):
    assert port.hash_context(seed, salt, step) == \
        ref.hash_context(seed, salt, step)


@pytest.mark.parametrize("ctx", [0, 12345, 0xFFFFFFFF])
def test_hash_uniform_bitwise(ctx):
    gids = np.concatenate([np.arange(5000), [2 ** 33 + 17, 2 ** 62 - 1]])
    got, want = port.hash_uniform(gids, ctx), ref.hash_uniform(gids, ctx)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port._fmix32(gids.astype(np.uint32)),
                                  ref._fmix32(gids.astype(np.uint32)))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("B,k,seed", [(12, 4, 0), (12, 4, 1), (48, 16, 2),
                                      (6, 6, 3), (5, 1, 4)])
def test_presample_race_select_bitwise(B, k, seed):
    s = _scores(seed, B)
    ctx = ref.hash_context(seed, 4211, 3)
    _assert_same(port.presample_race_select(s, k, ctx=ctx),
                 ref.presample_race_select(s, k, ctx=ctx))


@pytest.mark.parametrize("B,k,seed", [(12, 4, 0), (12, 4, 1), (48, 16, 2),
                                      (6, 6, 3), (5, 1, 4)])
def test_presample_race_select_raw_bitwise(B, k, seed):
    s = _scores(seed + 10, B)
    ctx = ref.hash_context(seed, 4211, 5)
    _assert_same(port.presample_race_select_raw(s, k, ctx=ctx),
                 ref.presample_race_select_raw(s, k, ctx=ctx))


def test_ht_weights_bitwise():
    p = np.random.default_rng(0).dirichlet(np.ones(30))
    np.testing.assert_array_equal(port.ht_weights(p, 7.5, 30),
                                  ref.ht_weights(p, 7.5, 30))
