"""Scoring: ``repro_torch.score`` against ``repro.score`` at the ``smoke``
preset (lm-tiny reduced), with the same parameters, under the ``fused``
route and the ``pallas`` route (K1; the JAX kernel in interpret mode, the
port's plain version on the CPU), for the source's first batch, gathered
ids and a given batch. Training with ``score_impl="pallas"`` raises in
both packages: the kernel has no gradient."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.api import build_run as jax_build_run  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.api import build_run  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402

F32_TOL = 1e-5      # f32 on both sides; sums differ in order only
BF16_TOL = 3e-2     # bf16 compute rounds at other places in the two


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's {name: tensor}) of the smoke model."""
    run = jax_build_run("lm-tiny", preset="smoke")
    jp = JaxLM(run.model).init(jax.random.PRNGKey(run.seed))
    flat, _ = _flatten(jp)
    lm = interop.params_from_numpy({k: np.asarray(v) for k, v in flat.items()},
                                   build_run("lm-tiny", preset="smoke").model,
                                   "cpu")
    return jp, dict(lm.named_parameters())


@pytest.mark.parametrize("impl", ["fused", "pallas"])
@pytest.mark.parametrize("score_dtype,tol", [("float32", F32_TOL),
                                             ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("which", ["first", "gids", "batch"])
def test_score_matches_reference(params, impl, score_dtype, tol, which):
    jp, pp = params
    overrides = {"imp.score_impl": impl, "imp.score_dtype": score_dtype}
    kw = {}
    if which == "gids":
        kw["gids"] = [5, 900, 3, 65535]
    elif which == "batch":
        rng = np.random.default_rng(2)
        kw["batch"] = {"tokens": rng.integers(0, 256, (3, 32)).astype(np.int32),
                       "labels": rng.integers(0, 256, (3, 32)).astype(np.int32)}
    want = repro.score("lm-tiny", params=jp, preset="smoke",
                       overrides=overrides, **kw)
    got = repro_torch.score("lm-tiny", params=pp, preset="smoke",
                            overrides=overrides, device="cpu", **kw)
    n = {"first": 8, "gids": 4, "batch": 3}[which]
    for g, w in zip(got, want):
        assert g.shape == (n,) and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)


def test_pallas_and_fused_routes_agree(params):
    """K1's route and the direct reductions score alike (the reference's
    two routes agree to about 1e-6 at this preset too)."""
    _, pp = params
    kw = dict(params=pp, preset="smoke", device="cpu")
    lf, sf = repro_torch.score("lm-tiny", overrides={
        "imp.score_impl": "fused", "imp.score_dtype": "float32"}, **kw)
    lp, sp = repro_torch.score("lm-tiny", overrides={
        "imp.score_impl": "pallas", "imp.score_dtype": "float32"}, **kw)
    np.testing.assert_allclose(lp, lf, atol=2e-6, rtol=0)
    np.testing.assert_allclose(sp, sf, atol=2e-6, rtol=0)


def test_score_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.score("lm-tiny", preset="smoke")


def test_training_with_the_pallas_route_raises():
    """Neither package can train through the scoring kernel: it has no
    gradient (the JAX step fails while differentiating the Pallas call).
    ``prod``'s path, which both packages run."""
    overrides = {"imp.score_impl": "pallas", "shape.seq_len": 16,
                 "shape.global_batch": 4, "obs.enabled": False, "steps": 1}
    with pytest.raises(AssertionError):    # raised under jax's transform
        repro.train("lm-tiny", preset="prod", overrides=overrides)
    with pytest.raises(RuntimeError, match="no gradient"):
        repro_torch.train("lm-tiny", preset="prod", overrides=overrides,
                          device="cpu")
