"""The port's ``ScoreStore`` is bitwise the reference's
(``repro.sampler.store.ScoreStore``) on the same update sequence: EMA
merges with repeats, sentinel and non-finite entries, unowned ids of a
strided shard, decay toward its own or a given mean, the global reads,
the distribution and τ, ``topk`` and a state-dict round trip."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.sampler.store import ScoreStore as RefStore  # noqa: E402
from repro_torch.sampler.store import ScoreStore  # noqa: E402


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _drive(store, n, seed):
    """One seeded sequence of writes; returns what each call returned."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        gids = rng.integers(0, n, 40)                 # repeats included
        s = rng.lognormal(0.0, 1.0, 40).astype(np.float32)
        s[rng.random(40) < 0.1] = -1.0                # sentinel
        s[rng.random(40) < 0.05] = np.nan             # non-finite
        out.append(store.update(gids, s))
        if i == 2:
            store.decay()
        if i == 4:
            store.decay(mean=1.25)
    return out


@pytest.mark.parametrize("n,host_id,n_hosts", [(97, 0, 1), (100, 1, 3),
                                               (5, 0, 1)])
def test_store_bitwise_vs_reference(n, host_id, n_hosts):
    kw = dict(host_id=host_id, n_hosts=n_hosts, ema=0.8, staleness=0.7)
    got, want = ScoreStore(n, **kw), RefStore(n, **kw)
    assert _drive(got, n, seed=n) == _drive(want, n, seed=n)
    assert got.n_local == want.n_local
    for name in ("scores", "seen", "updates"):
        _same(getattr(got, name), getattr(want, name))
    assert got.coverage() == want.coverage()
    assert got.version == want.version
    _same(got.sentinel_scores(), want.sentinel_scores())
    _same(got.my_global_ids(), want.my_global_ids())
    gids = np.arange(n)
    _same(got.owned(gids), want.owned(gids))
    _same(got.slot(gids), want.slot(gids))
    for sm, temp in ((0.1, 1.0), (0.3, 0.5)):
        _same(got.distribution(sm, temp), want.distribution(sm, temp))
        p = got.distribution(sm, temp)
        assert got.tau_from(p) == want.tau_from(p)
    pool = want.my_global_ids()[: max(want.n_local // 2, 1)]
    _same(got.topk(pool, 5), want.topk(pool, 5))
    if n_hosts == 1:
        _same(got.global_scores(), want.global_scores())
        for temp in (1.0, 0.5):
            _same(got.global_distribution(0.1, temp),
                  want.global_distribution(0.1, temp))
    else:
        with pytest.raises(ValueError, match="unowned"):
            got.topk(np.arange(n), 3)
        with pytest.raises(NotImplementedError, match="distributed slice"):
            got.global_scores()
    # state dict: round trip into a fresh store, in both directions
    for src, dst in ((got, RefStore(n, **kw)), (want, ScoreStore(n, **kw))):
        dst.load_state_dict(src.state_dict())
        for name in ("scores", "seen", "updates"):
            _same(getattr(dst, name), getattr(src, name))
        assert dst.coverage() == src.coverage()


def test_global_scores_cache_invalidates_on_every_write():
    st = ScoreStore(12)
    g1 = st.global_scores(use_cache=True)
    assert st.global_scores(use_cache=True) is g1        # a cache hit
    for write in (lambda: st.update([0], [2.0]),
                  lambda: st.update([1], [-1.0]),        # filtered write
                  lambda: st.decay(),
                  lambda: st.load_state_dict(st.state_dict())):
        write()
        g2 = st.global_scores(use_cache=True)
        assert g2 is not g1
        g1 = g2
    assert g1[0] == 2.0


def test_distribution_from_and_tau_bitwise():
    rng = np.random.default_rng(3)
    s = rng.lognormal(0.0, 1.0, 500).astype(np.float32)
    s[rng.random(500) < 0.3] = -1.0
    for sm, temp in ((0.0, 1.0), (0.1, 0.5), (0.5, 2.0)):
        p = ScoreStore.distribution_from(s, sm, temp)
        _same(p, RefStore.distribution_from(s, sm, temp))
        assert ScoreStore.tau_from(p) == RefStore.tau_from(p)
    _same(ScoreStore.distribution_from(np.full(4, -1.0, np.float32)),
          RefStore.distribution_from(np.full(4, -1.0, np.float32)))
