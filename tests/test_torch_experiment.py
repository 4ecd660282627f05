"""The port's ``Experiment`` facade against the reference's
(``repro.api.experiment.Experiment``): it keeps ``last_state`` after
``fit``; ``score(params, batch)`` goes through its ``ScoreEngine`` and
equals ``repro_torch.score`` and the reference's ``Experiment.score`` on
the same parameters; ``serve(params=None, **kw)`` serves the last trained
parameters (before any ``fit``, the model ``serve`` initialises itself),
on the experiment's device. lm-tiny at the ``smoke`` preset, f32, CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro_torch  # noqa: E402
from repro.api import Experiment as JaxExperiment  # noqa: E402
from repro.api import build_run as jax_build_run  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.api import Experiment, build_run  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402

F32_TOL = 1e-5      # f32 on both sides; sums differ in order only
OV = {"shape.seq_len": 16, "shape.global_batch": 4, "steps": 3,
      "obs.enabled": False}
SERVE = {"batch": 2, "prompt_len": 8, "gen": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread, so the parallel test
    workers that share the host's cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fit_keeps_last_state_and_serve_serves_it():
    run = build_run("lm-tiny", preset="smoke", overrides=OV)
    exp = Experiment(run, device="cpu")
    assert exp.last_state is None
    untrained = exp.serve(**SERVE)["tokens"]
    np.testing.assert_array_equal(
        untrained,
        repro_torch.serve(run.model, device="cpu", **SERVE)["tokens"])
    state, hist = exp.fit()
    assert len(hist) == 3
    assert exp.last_state is state
    got = exp.serve(**SERVE)
    want = repro_torch.serve(run.model, params=state["params"],
                             device="cpu", **SERVE)
    assert got["tokens"].shape == (SERVE["batch"], SERVE["gen"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_score_matches_module_score_and_reference():
    ov = dict(OV, **{"imp.score_dtype": "float32"})
    jrun = jax_build_run("lm-tiny", preset="smoke", overrides=ov)
    jp = JaxLM(jrun.model).init(jax.random.PRNGKey(jrun.seed))
    flat, _ = _flatten(jp)
    run = build_run("lm-tiny", preset="smoke", overrides=ov)
    exp = Experiment(run, device="cpu")
    interop.load_params(exp.lm, {k: np.asarray(v) for k, v in flat.items()})
    params = dict(exp.lm.named_parameters())
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 256, (5, 16)).astype(np.int32),
             "labels": rng.integers(0, 256, (5, 16)).astype(np.int32)}
    got = exp.score(params, batch)
    module = repro_torch.score(run, params=params, batch=batch, device="cpu")
    want = JaxExperiment(jrun).score(jp, batch)
    for g, m, w in zip(got, module, want):
        assert isinstance(g, np.ndarray) and g.shape == (5,)
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, m)
        np.testing.assert_allclose(g, np.asarray(w), atol=F32_TOL,
                                   rtol=F32_TOL)
