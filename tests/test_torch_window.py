"""Sliding-window attention (``attn_local``) and its ring cache in the
port, against the JAX package, on seeded numpy inputs, f32:

* ``_mask``, ``naive_attention`` and ``online_attention`` with a window;
  the port's band of kv chunks is exact for every (q_chunk, kv_chunk) in
  {16, 32, 64}², the reference's only where q_chunk ≥ kv_chunk (its
  failing example ``window=8, qc=16, kc=32, seed=0`` is a case);
* K5's route rule (``attention.flash_route``) and the ring's write order
  (``attention.ring_write_in_order``) as pure functions; the flash op's
  plain version over a wrapped ring, not causal, against
  ``naive_attention`` with the ring's positions; and, at every attention
  call of serve's steps over rings filled by prompts shorter than, equal
  to, longer than and a multiple of the ring, the route's answer against
  ``naive_attention`` wherever the rule takes it;
* ``reduced(gemma3-12b, repeats=2)`` (window 64, 5 local : 1 global),
  initialised in JAX and loaded through ``interop``: logits and loss,
  ``serve`` for prompts of 40 (decode wraps
  the ring), 64 (= the window) and 100 tokens (longer than the ring: the
  reference keeps its last 64 keys, so early queries see none, and the
  port reproduces that), and ``score``. Its ``prod`` step is in
  ``tests/test_torch_archs.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.api import build_run as jax_build_run  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.api import build_run  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attn.ops import flash_attention  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402

ATOL = 1e-5          # f32 on both sides; sums differ in order only
CHUNKS = (16, 32, 64)


def _qkv(seed, b=1, s=128, hq=2, hkv=2, hd=8):
    """The reference property test's inputs (``tests/test_models.py``)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, hq, hd).astype(np.float32),
            rng.randn(b, s, hkv, hd).astype(np.float32),
            rng.randn(b, s, hkv, hd).astype(np.float32))


def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread, so the parallel test
    workers that share the host's cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the window in the plain paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 1, 8, 24])
def test_mask_matches_reference(window):
    rng = np.random.default_rng(window)
    q_pos = rng.integers(0, 50, (2, 7)).astype(np.int32)
    kv_pos = rng.integers(-1, 50, (2, 11)).astype(np.int32)  # -1: empty
    want = np.asarray(jattn._mask(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                  window))
    got = pattn._mask(*_t(q_pos, kv_pos), window).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window", [0, 8, 40])
def test_naive_attention_matches_reference(window):
    q, k, v = _qkv(3, b=2, s=48, hq=4, hkv=2)
    pos = _pos(2, 48)
    want = jattn.naive_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                 window=window)
    got = pattn.naive_attention(*_t(q, k, v, pos, pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("qc", CHUNKS)
@pytest.mark.parametrize("kc", CHUNKS)
def test_online_attention_band_is_exact(qc, kc):
    """The port's banded ``online_attention`` equals ``naive_attention``
    for every chunk pair and window, and the reference's
    ``online_attention`` where its band is wide enough (q_chunk ≥
    kv_chunk). At the reference's failing example it is not, and the
    port's is."""
    for seed, window in enumerate((8, 40, 100)):
        q, k, v = _qkv(seed)
        pos = _pos(1, 128)
        naive = pattn.naive_attention(*_t(q, k, v, pos, pos), window=window)
        got = pattn.online_attention(*_t(q, k, v, pos, pos), window=window,
                                     q_chunk=qc, kv_chunk=kc)
        np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=ATOL,
                                   rtol=0, err_msg=f"window {window}")
        failing = (window, qc, kc, seed) == (8, 16, 32, 0)
        if qc < kc and not failing:
            continue
        ref = np.asarray(jattn.online_attention(
            *map(jnp.asarray, (q, k, v, pos, pos)), window=window,
            q_chunk=qc, kv_chunk=kc))
        if qc >= kc:
            np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
        else:
            # the seed failure tests/test_models.py::
            # test_banded_window_attention_property: the reference's band
            # misses the kv chunk a straddling q chunk needs
            assert np.abs(ref - naive.numpy()).max() > 0.1


# ---------------------------------------------------------------------------
# K5's route rule and the ring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args,want", [
    # (q_offset, sq, skv, window, ring) -> (n, causal, window, q_offset)
    ((None, 64, 64, 0, False), None),               # no word: plain paths
    ((0, 64, 64, 0, False), (64, True, 0, 0)),      # scoring forward
    ((0, 64, 64, 16, False), (64, True, 16, 0)),    # windowed scoring
    ((0, 40, 104, 0, False), (40, True, 0, 0)),     # global prefill
    ((57, 1, 104, 0, False), (58, True, 0, 57)),    # global decode
    ((0, 40, 64, 64, True), (40, True, 64, 0)),     # ring prefill
    ((0, 64, 64, 64, True), (64, True, 64, 0)),     # prompt = the ring
    ((50, 1, 64, 64, True), (51, True, 64, 50)),    # decode, before wrap
    ((63, 1, 64, 64, True), (64, True, 64, 63)),    # fills the last slot
    ((64, 1, 64, 64, True), (64, False, 0, 0)),     # decode, wrapped
    ((500, 1, 64, 64, True), (64, False, 0, 0)),
    ((0, 100, 64, 64, True), None),                 # prompt > the ring
    ((64, 2, 64, 64, True), None),                  # a block that wraps
    ((40, 1, 32, 64, True), None),                  # ring < window, full
    # (..., in_order): a ring written out of step with its slots
    ((100, 1, 64, 64, True, False), None),          # after a 100 prefill
    ((10, 1, 64, 64, True, False), None),
    ((128, 1, 64, 64, True, True), (64, False, 0, 0)),  # after 128 = 2·64
    ((57, 1, 104, 0, False, False), (58, True, 0, 57)),  # global: no flag
])
def test_flash_route_rule(args, want):
    assert pattn.flash_route(*args) == want


@pytest.mark.parametrize("q_offset,s,cap,want", [
    (0, 40, 64, True), (0, 64, 64, True), (0, 100, 64, False),
    (0, 128, 64, True), (36, 64, 64, False), (63, 1, 64, True),
    (64, 1, 64, True), (100, 1, 64, True), (60, 8, 64, False),
    (None, 1, 64, False)])
def test_ring_write_in_order(q_offset, s, cap, want):
    assert pattn.ring_write_in_order(q_offset, s, cap) is want


def test_flash_plain_route_over_a_wrapped_ring():
    """Decode after the wrap of a ring written in order: K5's call over the
    whole ring (not causal,
    no window, q_offset 0; here its plain version on the CPU) equals
    ``naive_attention`` with the ring's own positions and the window."""
    window, b, hq, hkv, hd = 16, 2, 4, 2, 8
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, 1, hq, hd), (b, window, hkv, hd),
                         (b, window, hkv, hd)))
    qpos = 37
    slots = np.arange(window)
    # slot j holds the last position ≡ j (mod window) at or before qpos
    kv_pos = qpos - (qpos - slots) % window
    kv_pos = np.broadcast_to(kv_pos[None], (b, window)).astype(np.int32)
    q_pos = np.full((b, 1), qpos, np.int32)
    route = pattn.flash_route(qpos, 1, window, window, ring=True)
    n, causal, win, off = route
    tq, tk, tv = _t(q, k, v)
    got = flash_attention(tq, tk[:, :n], tv[:, :n], causal=causal,
                          window=win, q_offset=off)
    want = pattn.naive_attention(tq, tk, tv, *_t(q_pos, kv_pos),
                                 window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("prompt_len,gen,after_wrap", [
    (40, 30, True), (64, 4, True), (100, 4, False), (128, 4, True)])
def test_flash_route_is_exact_where_serve_takes_it(gemma, monkeypatch,
                                                   prompt_len, gen,
                                                   after_wrap):
    """At every attention call of serve's prefill and decode steps
    (``q_offset`` given, as ``serve`` drives them), the call K5 would make
    where ``flash_route`` takes it (here the flash op's plain version)
    equals ``naive_attention`` over the cache with its stored positions.
    A prompt of 100 leaves the rings of 64 slots out of step with their
    positions: every ring call then takes the plain paths, and the wrapped
    ring's route would not be exact (slot 36 holds position 36, outside
    the window of position 100)."""
    _, _, lm = gemma
    real = pattn.attention_op
    seen = {"ring": [], "unguarded_gap": 0.0}

    def attention_op(q, k, v, q_pos, kv_pos, **kw):
        route = pattn.flash_route(kw["q_offset"], q.shape[1], k.shape[1],
                                  kw["window"], kw["ring"],
                                  kw["in_order"])
        want = pattn.naive_attention(q, k, v, q_pos, kv_pos, kw["window"])
        if route is not None:
            n, causal, win, off = route
            got = flash_attention(q, k[:, :n], v[:, :n], causal=causal,
                                  window=win, q_offset=off)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                       rtol=0, err_msg=str((route, kw)))
        if kw["ring"]:
            seen["ring"].append(route)
            if not kw["in_order"] and q.shape[1] == 1:
                whole = flash_attention(q, k, v, causal=False)
                seen["unguarded_gap"] = max(seen["unguarded_gap"], float(
                    (whole - want).abs().max()))
        return real(q, k, v, q_pos, kv_pos, **kw)
    monkeypatch.setattr(pattn, "attention_op", attention_op)
    b = 2
    toks = torch.from_numpy(np.random.default_rng(prompt_len).integers(
        0, 256, (b, prompt_len + gen)))
    caches = lm.caches(b, prompt_len + gen)
    with torch.inference_mode():
        lm.serve_step(caches, {"tokens": toks[:, :prompt_len]}, q_offset=0)
        for i in range(gen):
            p = prompt_len + i
            lm.serve_step(caches, {"tokens": toks[:, p:p + 1]}, q_offset=p)
    n_rings = 10                              # 2 repeats × 5 local layers
    assert len(seen["ring"]) == n_rings * (gen + 1)
    decode = seen["ring"][n_rings:]
    wrapped = [r for r in decode if r == (64, False, 0, 0)]
    if after_wrap:
        assert all(r is not None for r in decode)
        assert wrapped
    else:
        assert all(r is None for r in seen["ring"])
        assert seen["unguarded_gap"] > 100 * ATOL, seen["unguarded_gap"]


def test_ring_cache_shapes():
    cfg = reduced(get_config("gemma3-12b"), repeats=2)
    from repro_torch.models.transformer import caches_init
    caches = caches_init(cfg, 2, 100, torch.float32, "cpu")
    segs = caches["seg0"]
    assert sorted(segs) == [f"p{i}" for i in range(6)]
    for pi in range(6):
        assert len(segs[f"p{pi}"]) == 2
        want = 64 if pi < 5 else 100          # rings: min(100, window 64)
        assert segs[f"p{pi}"][1]["k"].shape == (2, want, 2, 16)
        assert (segs[f"p{pi}"][1]["pos"] == -1).all()
        assert segs[f"p{pi}"][1].get("in_order") is (True if pi < 5
                                                      else None)


# ---------------------------------------------------------------------------
# reduced gemma3 against the reference
# ---------------------------------------------------------------------------
CAP = 128               # one cache geometry for every prompt length


@pytest.fixture(scope="module")
def gemma():
    """(JAX LM, its params, the port's LM holding the same params)."""
    jcfg = jax_reduced(jax_get_config("gemma3-12b"), repeats=2)
    cfg = reduced(get_config("gemma3-12b"), repeats=2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.sliding_window == 64 and cfg.resolved_head_dim == 16
    jlm = JaxLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    flat, _ = _flatten(params)
    lm = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in flat.items()}, cfg, "cpu")
    return jlm, params, lm


@pytest.fixture(scope="module")
def jax_serve_step(gemma):
    """The reference's ``serve_step``, jitted once for the module (its
    decode step compiles once for the one cache geometry)."""
    return jax.jit(gemma[0].serve_step)


def _batch(seq, b=2, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (b, seq)).astype(np.int32)
    labels[:, -3:] = -1
    return {"tokens": rng.integers(0, vocab, (b, seq)).astype(np.int32),
            "labels": labels}


def test_gemma3_logits_and_loss_match_reference(gemma):
    jlm, params, lm = gemma
    batch = _batch(48, seed=48)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, _ = jlm.logits(params, jb)
    got = lm(tb).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    jloss, _ = jlm.loss(params, jb, remat=False)
    loss, _ = lm.loss(tb, remat=False)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("prompt_len,gen", [(40, 28), (64, 6), (100, 6)])
def test_gemma3_serve_matches_reference(gemma, jax_serve_step, prompt_len,
                                        gen):
    """Greedy decoding through the reference's ``serve_step`` (jitted) and
    ``repro_torch.serve`` give the same tokens; the port's ``serve_step``
    (``q_offset`` given, as ``serve`` drives it) and its plain route
    (explicit positions) give the reference's last-position logits at the
    prefill and at every teacher-forced decode step, before and after the
    rings wrap (at position 64: the 40-token prompt's 28 tokens cross it,
    the longer prompts start past it), and the rings hold the reference's
    K, V and positions."""
    jlm, params, lm = gemma
    b = 2
    prompts = np.random.default_rng(prompt_len).integers(
        0, 256, (b, prompt_len)).astype(np.int32)
    step = jax_serve_step
    jc = jlm.caches(b, CAP)
    pos = _pos(b, prompt_len)
    logits, jc = step(params, jc, {"tokens": jnp.asarray(prompts),
                                   "positions": jnp.asarray(pos)})
    want, toks = [np.asarray(logits)], []
    for i in range(gen):
        tok = np.asarray(jnp.argmax(logits[:, -1], -1))[:, None] \
            .astype(np.int32)
        toks.append(tok)
        if i == gen - 1:
            break
        logits, jc = step(params, jc, {
            "tokens": jnp.asarray(tok),
            "positions": jnp.full((b, 1), prompt_len + i, jnp.int32)})
        want.append(np.asarray(logits))
    toks = np.concatenate(toks, 1)
    got = repro_torch.serve(lm.cfg, params=lm.state_dict(), prompts=prompts,
                            gen=gen, cap=CAP, device="cpu")
    np.testing.assert_array_equal(got["tokens"], toks)
    for route in ("q_offset", "positions"):
        caches = lm.caches(b, CAP)
        with torch.inference_mode():
            for i in range(gen):
                feed = prompts if i == 0 else toks[:, i - 1:i]
                start = 0 if i == 0 else prompt_len + i - 1
                s = {"tokens": torch.from_numpy(np.ascontiguousarray(feed))}
                if route == "q_offset":
                    out, caches = lm.serve_step(caches, s, q_offset=start)
                else:
                    s["positions"] = torch.arange(
                        start, start + feed.shape[1],
                        dtype=torch.int32)[None].expand(b, -1)
                    out, caches = lm.serve_step(caches, s)
                np.testing.assert_allclose(out.numpy(), want[i], atol=ATOL,
                                           rtol=0, err_msg=f"{route} {i}")
        for pi in (0, 5):                    # a ring and the global cache
            mine = caches["seg0"][f"p{pi}"][1]
            for name in ("k", "v", "pos"):
                ref = np.asarray(jc["seg0"][f"p{pi}"][name][1])
                np.testing.assert_allclose(mine[name].numpy(), ref,
                                           atol=ATOL, rtol=0)
    ring = caches["seg0"]["p0"][1]["pos"]
    assert ring.shape == (b, 64)
    last = prompt_len + gen - 2              # the last position fed
    assert int(ring.max()) == last


@pytest.mark.parametrize("prompt_len,exact", [(48, True), (64, True),
                                              (100, False)])
def test_ring_prefill_is_exact_only_within_the_window(gemma, prompt_len,
                                                      exact):
    """The reference's limit, which the port reproduces (its serve logits
    equal the reference's above): a prompt prefilled into rings of 64
    slots gives the last position's logits of a full forward while it fits
    the window, and not beyond it, where the rings keep only the last 64
    keys and earlier queries of the local layers see none."""
    _, _, lm = gemma
    prompts = torch.from_numpy(np.random.default_rng(prompt_len).integers(
        0, 256, (2, prompt_len)))
    with torch.inference_mode():
        full = lm({"tokens": prompts})[:, -1:]
        served, _ = lm.serve_step(lm.caches(2, CAP), {"tokens": prompts},
                                  q_offset=0)
    gap = float((served - full).abs().max())
    if exact:
        assert gap < ATOL, gap
    else:
        assert gap > 100 * ATOL, gap


def test_gemma3_score_matches_reference(gemma):
    _, params, lm = gemma
    batch = _batch(48, b=3, seed=4)
    overrides = {"imp.score_dtype": "float32"}
    jrun = jax_build_run(overrides=overrides, model=jax_reduced(
        jax_get_config("gemma3-12b"), repeats=2))
    prun = build_run(overrides=overrides, model=lm.cfg)
    want = repro.score(jrun, params=params, batch=batch)
    got = repro_torch.score(prun, params=dict(lm.named_parameters()),
                            batch=batch, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (3,) and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=ATOL)
