"""The port's copy of the selection math — the presample race and the
sharded store selection — is bitwise the reference's
(``repro.sampler.selection``) on seeded inputs; the K6 route and the
collectives' single-host identities agree with it too."""
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


# ---------------------------------------------------------------------------
# the sharded store selection (history / selective, imp.selection_impl=
# "sharded")
# ---------------------------------------------------------------------------
def _stores(n, host_id=0, n_hosts=1, seed=0, frac=0.8):
    """The port's and the reference's ScoreStore after the same seeded
    writes (a fraction ``frac`` of the ids seen)."""
    from repro.sampler.store import ScoreStore as RefStore
    from repro_torch.sampler.store import ScoreStore
    rng = np.random.default_rng(seed)
    gids = np.flatnonzero(rng.random(n) < frac)
    s = rng.lognormal(0.0, 1.0, gids.size).astype(np.float32)
    s[rng.random(gids.size) < 0.05] = 0.0              # zero scores too
    stores = []
    for cls in (ScoreStore, RefStore):
        st = cls(n, host_id=host_id, n_hosts=n_hosts)
        st.update(gids, s)
        stores.append(st)
    return stores


@pytest.mark.parametrize("temp", [1.0, 0.5])
@pytest.mark.parametrize("n,h,H", [(500, 0, 1), (1001, 2, 3)])
def test_shard_stats_and_global_dist_bitwise(n, h, H, temp):
    pst, rst = _stores(n, h, H, seed=n)
    st = port.shard_stats(pst.scores, pst.seen, temp)
    _assert_same([st], [ref.shard_stats(rst.scores, rst.seen, temp)])
    pd = port.GlobalDist(st, n, 0.1, temp)
    rd = ref.GlobalDist(st, n, 0.1, temp)
    for name in ("n", "lam", "inv_t", "n_seen", "fill_pow", "total",
                 "total_sq", "coverage"):
        assert getattr(pd, name) == getattr(rd, name), name
    assert pd.tau() == rd.tau()
    _assert_same([pd.probs(pst.scores, pst.seen)],
                 [rd.probs(rst.scores, rst.seen)])
    # an empty store: fill 1.0, coverage 0
    e = np.zeros(8, np.float32), np.zeros(8, np.uint8)
    ed, er = (m.GlobalDist(m.shard_stats(*e, temp), 8, 0.1, temp)
              for m in (port, ref))
    assert (ed.fill_pow, ed.coverage, ed.tau()) == \
        (er.fill_pow, er.coverage, er.tau())


@pytest.mark.parametrize("n,h,H,kc", [(500, 0, 1, 9), (1001, 2, 3, 17),
                                      (6, 0, 1, 9)])
def test_local_candidates_and_merge_bitwise(n, h, H, kc):
    pst, rst = _stores(n, h, H, seed=n + 1)
    stats = ref.shard_stats(rst.scores, rst.seen, 0.5)
    dist = ref.GlobalDist(stats, n, 0.1, 0.5)
    ctx = ref.hash_context(4, 9173, n)
    gids = rst.global_ids(np.arange(rst.n_local))
    got = port.local_candidates(pst.scores, pst.seen, gids,
                                port.GlobalDist(stats, n, 0.1, 0.5), kc,
                                ctx=ctx)
    want = ref.local_candidates(rst.scores, rst.seen, gids, dist, kc, ctx=ctx)
    for key in ("gid", "key", "prob"):
        _assert_same([got[key]], [want[key]])
    k = min(kc, rst.n_local) - 1
    _assert_same(port.merge_topk(got, k), ref.merge_topk(want, k))
    with pytest.raises(ValueError, match="k\\+1"):
        port.merge_topk(got, rst.n_local)
    gsel, psel, thr = ref.merge_topk(want, k)
    _assert_same([port.ht_weights(psel, thr, n)],
                 [ref.ht_weights(psel, thr, n)])


def test_local_candidates_kernel_vs_reference():
    """K6's route (the plain version on the CPU here) against the JAX
    kernel route (interpret mode) on the same 3-host shard: same winners in
    the same order, keys to f32 precision, probabilities bitwise."""
    n, h, H, kc = 3001, 1, 3, 17
    pst, rst = _stores(n, h, H, seed=5)
    stats = ref.shard_stats(rst.scores, rst.seen, 0.5)
    ctx = ref.hash_context(2, 9173, 11)
    got = port.local_candidates_kernel(
        pst, port.GlobalDist(stats, n, 0.1, 0.5), kc, ctx=ctx, device="cpu")
    want = ref.local_candidates_kernel(rst, ref.GlobalDist(stats, n, 0.1, 0.5),
                                       kc, ctx=ctx)
    _assert_same([got["gid"], got["prob"]], [want["gid"], want["prob"]])
    np.testing.assert_allclose(got["key"], want["key"], rtol=1e-6)
    # and the same winners as the float64 host loop
    loop = port.local_candidates(pst.scores, pst.seen,
                                 pst.global_ids(np.arange(pst.n_local)),
                                 port.GlobalDist(stats, n, 0.1, 0.5), kc,
                                 ctx=ctx)
    assert set(loop["gid"]) == set(got["gid"])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n,k,temp,seed", [(400, 8, 1.0, 0), (2000, 5, 0.5, 1),
                                           (9, 8, 1.0, 2)])
def test_sample_sharded_vs_reference(n, k, temp, seed, use_kernel):
    """The whole sharded draw: gids equal, weights and probs to 1e-6
    relative (exact on the numpy loop), and ``use_kernel=None`` on the CPU
    is the numpy loop."""
    pst, rst = _stores(n, seed=seed)
    stats = ref.shard_stats(rst.scores, rst.seen, temp)
    kw = dict(seed=seed, salt=9173, step=3 + seed, use_kernel=use_kernel)
    got = port.sample_sharded(pst, port.GlobalDist(stats, n, 0.1, temp), k,
                              device="cpu", **kw)
    want = ref.sample_sharded(rst, ref.GlobalDist(stats, n, 0.1, temp), k,
                              **kw)
    _assert_same([got[0]], [want[0]])
    if use_kernel:
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    else:
        _assert_same(got, want)
        auto = port.sample_sharded(pst, port.GlobalDist(stats, n, 0.1, temp),
                                   k, device="cpu",
                                   **dict(kw, use_kernel=None))
        _assert_same(auto, got)


@pytest.mark.parametrize("W,k,h,H", [(24, 8, 0, 1), (30, 6, 1, 3),
                                     (5, 5, 0, 1)])
def test_local_rank_candidates_and_merge_rank_bitwise(W, k, h, H):
    n = 64
    pst, rst = _stores(n, h, H, seed=W, frac=0.6)
    pool = (np.arange(W) * 7 + 3) % n
    got = port.local_rank_candidates(pool, pst, k)
    want = ref.local_rank_candidates(pool, rst, k)
    for key in ("pos", "pri"):
        _assert_same([got[key]], [want[key]])
    _assert_same([port.merge_rank(got, k)], [ref.merge_rank(want, k)])


@pytest.mark.parametrize("impl,n,b,H", [("auto", 10 ** 6, 64, 1),
                                        ("auto", 10 ** 5, 64, 8),
                                        ("auto", 10 ** 4, 64, 8),
                                        ("sharded", 100, 8, 1),
                                        ("gather", 10 ** 6, 8, 4)])
def test_resolve_selection_impl(impl, n, b, H):
    assert port.resolve_selection_impl(impl, n=n, b=b, n_hosts=H) == \
        ref.resolve_selection_impl(impl, n=n, b=b, n_hosts=H)


def test_collectives_are_identity_at_one_host_and_raise_beyond():
    from repro.distributed import collectives as rc
    from repro_torch.distributed import collectives as pc
    for n, h, H in ((10, 0, 1), (10, 1, 3), (11, 2, 3), (2, 1, 4)):
        assert pc.strided_shard_size(n, h, H) == rc.strided_shard_size(n, h, H)
    x = np.arange(6, dtype=np.float32)
    _assert_same([pc.gather_host_scores(x, n_global=4)], [x[:4]])
    _assert_same([pc.allgather_rows(x, n_rows=5)], [x[:5]])
    _assert_same([pc.allreduce_stats(x)], [x.astype(np.float64)])
    blk = {"gid": np.arange(3), "key": np.ones(3)}
    out = pc.exchange_topk(blk, k_each=3)
    _assert_same([out["gid"], out["key"]], [blk["gid"], blk["key"]])
    with pytest.raises(ValueError, match="padded"):
        pc.exchange_topk(blk, k_each=4)
    for call in (lambda: pc.gather_host_scores(x, n_hosts=2, n_global=12),
                 lambda: pc.allgather_rows(x, n_rows=12, n_hosts=2),
                 lambda: pc.allreduce_stats(x, n_hosts=2),
                 lambda: pc.exchange_topk(blk, k_each=3, n_hosts=2)):
        with pytest.raises(NotImplementedError, match="distributed slice"):
            call()
