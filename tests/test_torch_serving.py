"""Serving: the port's KV caches, ``LM.serve_step``, ``repro_torch.serve``
and its launcher against the JAX package's, at lm-tiny, f32, with the same
parameters (carried through the checkpoint format) and the same prompts.

``serve_step`` runs two ways: with ``q_offset`` (positions built from
it, and on the card attention through the flash op), as ``serve`` drives
it, and with explicit positions (the plain paths, masks from the
positions). Both must give the reference's logits at prefill and at every
decode step, and the caches must hold the reference's K, V and
positions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.api.config import ConfigError  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

ATOL = 1e-5      # f32 on both sides; sums differ in order only
B, P, GEN, CAP = 2, 19, 5, 32


@pytest.fixture(scope="module")
def models():
    jlm = jax_lm.LM(jax_get_config("lm-tiny"))
    params = jlm.init(jax.random.PRNGKey(0))
    flat, _ = _flatten(params)
    lm = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in flat.items()}, get_config("lm-tiny"),
        "cpu")
    return jlm, params, lm


def _prompts(seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, P)) \
        .astype(np.int32)


@pytest.mark.parametrize("route", ["flash", "plain"])
def test_serve_step_and_caches_match_reference(models, route):
    """Prefill P tokens into caches of CAP slots, then GEN teacher-forced
    decode steps: last-position logits at every step and the caches'
    K/V/positions equal the reference's."""
    jlm, params, lm = models
    prompts = _prompts()
    follow = np.random.default_rng(1).integers(0, 512, (B, GEN)) \
        .astype(np.int32)
    jc = jlm.caches(B, CAP)
    pc = lm.caches(B, CAP)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32)[None], (B, P))
    steps = [(prompts, pos, 0)] + [
        (follow[:, i:i + 1], np.full((B, 1), P + i, np.int32), P + i)
        for i in range(GEN)]
    with torch.inference_mode():
        for toks, p, off in steps:
            want, jc = jlm.serve_step(params, jc, {
                "tokens": jnp.asarray(toks), "positions": jnp.asarray(p)})
            step = {"tokens": torch.from_numpy(toks)}
            if route == "flash":
                got, pc = lm.serve_step(pc, step, q_offset=off)
            else:
                step["positions"] = torch.from_numpy(np.ascontiguousarray(p))
                got, pc = lm.serve_step(pc, step)
            assert got.shape == (B, 1, 512)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0)
    n_layers = lm.cfg.segments[0].repeats
    for layer in range(n_layers):
        mine = pc["seg0"]["p0"][layer]
        for name in ("k", "v", "pos"):
            ref = np.asarray(jc["seg0"]["p0"][name][layer])
            np.testing.assert_allclose(mine[name].numpy(), ref, atol=ATOL,
                                       rtol=0, err_msg=name)
    filled = P + GEN
    assert (mine["pos"][:, :filled].numpy() == np.arange(filled)).all()
    assert (mine["pos"][:, filled:] == -1).all()


def test_cache_insert_is_in_place(models):
    """Decode writes one slot of the caches it was given; nothing else of
    them changes and no new cache tensor is made."""
    _, _, lm = models
    caches = lm.caches(B, CAP)
    layer0 = caches["seg0"]["p0"][0]
    ptrs = {k: t.data_ptr() for k, t in layer0.items()}
    with torch.inference_mode():
        lm.serve_step(caches, {"tokens": torch.from_numpy(_prompts())},
                      q_offset=0)
        before = {k: t.clone() for k, t in layer0.items()}
        lm.serve_step(caches, {"tokens": torch.zeros((B, 1), dtype=torch.int32)},
                      q_offset=P)
    assert {k: t.data_ptr() for k, t in layer0.items()} == ptrs
    for k, t in layer0.items():
        changed = (t != before[k]).reshape(B, CAP, -1).any(-1).any(0)
        assert changed.nonzero().flatten().tolist() in ([P], []), k
    assert layer0["pos"][:, P].tolist() == [P] * B


def test_serve_step_refuses_positions_with_q_offset(models):
    """``q_offset`` defines the positions: a step given both is refused,
    so the two cannot disagree."""
    _, _, lm = models
    caches = lm.caches(B, CAP)
    pos = torch.arange(P, dtype=torch.int32)[None].expand(B, P)
    with torch.inference_mode(), pytest.raises(ValueError, match="not both"):
        lm.serve_step(caches, {"tokens": torch.from_numpy(_prompts()),
                               "positions": pos}, q_offset=0)


def test_serve_tokens_match_reference(models):
    """``repro_torch.serve`` and ``repro.serve`` decode the same greedy
    tokens from the same params and prompts."""
    jlm, params, lm = models
    prompts = _prompts(seed=3)
    want = repro.serve("lm-tiny", params=params, prompts=prompts, gen=GEN)
    got = repro_torch.serve("lm-tiny", params=lm.state_dict(),
                            prompts=prompts, gen=GEN, device="cpu")
    assert got["tokens"].shape == (B, GEN)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for key in ("prefill_s", "decode_s", "tok_per_s"):
        assert np.isfinite(got[key]) and got[key] >= 0


def test_serve_checks_the_cache_capacity():
    for serve in (repro.serve, repro_torch.serve):
        kw = {} if serve is repro.serve else {"device": "cpu"}
        with pytest.raises(ValueError, match="cannot hold"):
            serve("lm-tiny", batch=1, prompt_len=8, gen=4, cap=11, **kw)


def test_serve_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="distributed slice"):
        repro_torch.serve("lm-tiny", mesh=object(), device="cpu")
    from repro_torch.launch import serve as launcher
    with pytest.raises(ConfigError, match="mesh"):
        launcher.main(["--arch", "lm-tiny", "--smoke", "--mesh", "pod",
                       "--device", "cpu"])


def test_serve_launcher_smoke_on_cpu(capsys):
    from repro_torch.launch import serve as launcher
    out = launcher.main(["--arch", "lm-tiny", "--smoke", "--gen", "3",
                         "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill b=2 len=32")
    assert lines[1].startswith("decode 3 steps")
