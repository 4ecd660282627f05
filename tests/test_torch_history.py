"""The score-memory schemes end to end: the JAX ``Experiment`` and the
port's ``Experiment`` train lm-tiny for 6 steps under ``history`` (sharded
and gather selection), ``selective`` (sharded) and ``imp.enabled=false``
(uniform) from the same params, on the same 20-example source (so the
epoch rolls and the store decays within the run), and must agree — plan
gids exactly, weights and the τ flag to float32 rounding, losses to 1e-4
at every step.

A hook warms the store at loop start with seeded log-normal scores for 4
ids (coverage 0.2, under ``min_coverage`` 0.25): the first plans run the
gate's warm-up, and once the first step's feedback lifts coverage past
0.25 the gate opens and the weighted plans run. (At random init lm-tiny's
own scores agree to 0.3 %, too flat to pass any τ gate in 6 steps.) The
two frameworks' fed-back scores differ in the last ulps, so the weights
are held to 1e-6 relative, not bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import Experiment as JaxExperiment  # noqa: E402
from repro.api import Hook as JaxHook  # noqa: E402
from repro.api import build_run as jax_build_run  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.api import Experiment, Hook, build_run  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.data.pipeline import PipelineState, SyntheticLM  # noqa: E402

LOSS_TOL = 1e-4
WEIGHT_RTOL = 1e-6
N = 20                                   # examples in the source
WARM_IDS = np.array([9, 13, 15, 18])     # never in the first two plans
WARM_SCORES = np.random.default_rng(0).lognormal(1.0, 1.0, 4) \
    .astype(np.float32)

BASE = {"shape.seq_len": 16, "shape.global_batch": 4, "steps": 6,
        "obs.enabled": False, "sampler.min_coverage": 0.25,
        "sampler.tau_th": 1.001, "sampler.gate_every": 1}


def _hooks(base):
    class Warm(base):
        def on_loop_start(self, loop, start, steps):
            loop.exp.sampler.store.update(WARM_IDS, WARM_SCORES)

    class Plans(base):
        def __init__(self):
            self.plans = []

        def on_step_start(self, loop, step, batch, meta):
            self.plans.append((np.array(meta.gids), None if meta.weights is None
                               else np.array(meta.weights),
                               float(meta.is_flag)))
    return Warm(), Plans()


def _run_both(overrides):
    overrides = dict(BASE, **overrides)
    jrun = jax_build_run("lm-tiny", preset="prod", overrides=overrides)
    prun = build_run("lm-tiny", preset="prod", overrides=overrides)
    vocab = jrun.model.vocab_size

    jwarm, jrec = _hooks(JaxHook)
    jexp = JaxExperiment(jrun, source=JaxSyntheticLM(vocab, 16, n_examples=N,
                                                     seed=jrun.seed))
    _, jhist = jexp.fit(hooks=[jwarm, jrec])

    params = JaxLM(jrun.model).init(jax.random.PRNGKey(jrun.seed))
    flat, _ = _flatten(params)
    pwarm, prec = _hooks(Hook)
    exp = Experiment(prun, source=SyntheticLM(vocab, 16, n_examples=N,
                                              seed=prun.seed), device="cpu")
    interop.load_params(exp.lm, {k: np.asarray(v) for k, v in flat.items()})
    _, hist = exp.fit(hooks=[pwarm, prec])
    return (exp, hist, prec.plans), (jexp, jhist, jrec.plans)


@pytest.mark.parametrize("scheme,impl,gated", [
    ("history", "sharded", True),
    ("history", "gather", True),
    ("selective", "sharded", False),
])
def test_store_schemes_match_reference_experiment(scheme, impl, gated):
    (exp, hist, plans), (jexp, jhist, jplans) = _run_both(
        {"sampler.scheme": scheme, "imp.selection_impl": impl})
    assert exp.sampler.scheme == jexp.sampler.scheme == scheme
    assert exp.sampler.impl == jexp.sampler.impl == impl
    assert len(hist) == len(jhist) == 6
    for step, ((g, w, f), (jg, jw, jf)) in enumerate(zip(plans, jplans)):
        np.testing.assert_array_equal(g, jg, err_msg=f"gids, step {step}")
        assert (w is None) == (jw is None)
        if w is not None:
            np.testing.assert_allclose(w, jw, rtol=WEIGHT_RTOL, atol=0,
                                       err_msg=f"weights, step {step}")
        assert f == pytest.approx(jf, rel=WEIGHT_RTOL)
    for m, jm in zip(hist, jhist):
        np.testing.assert_allclose(m["loss"], jm["loss"], atol=LOSS_TOL,
                                   rtol=0)
        for key in ("sampler_active", "store_tau", "is_active", "tau"):
            if key in jm:
                np.testing.assert_allclose(m[key], jm[key], atol=LOSS_TOL)
    if gated:
        active = [h["sampler_active"] for h in hist]
        assert active[0] == 0.0 and any(active), active
        # the open gate's plans carry non-unit Horvitz–Thompson weights
        assert any(f > 1.0 and not np.allclose(w, 1.0)
                   for _, w, f in plans), plans
    np.testing.assert_array_equal(exp.sampler.store.seen,
                                  jexp.sampler.store.seen)
    np.testing.assert_allclose(exp.sampler.store.scores,
                               jexp.sampler.store.scores, rtol=1e-5)


def test_state_dict_matches_reference_and_replans():
    """The history sampler's checkpoint state has the reference's layout,
    and a fresh sampler loaded from it draws the same next plan."""
    (exp, _, _), (jexp, _, _) = _run_both(
        {"sampler.scheme": "history", "imp.selection_impl": "sharded"})
    d, jd = exp.sampler.state_dict(), jexp.sampler.state_dict()
    assert sorted(d) == sorted(jd) and sorted(d["store"]) == sorted(jd["store"])
    for key in ("tau_gate", "obs", "cov_global", "gate_dirty", "epoch"):
        np.testing.assert_allclose(d[key], jd[key], rtol=1e-6)
    np.testing.assert_array_equal(d["store"]["seen"], jd["store"]["seen"])
    fresh = Experiment(exp.run, source=exp.source, device="cpu")
    fresh.sampler.load_state_dict(d)
    pstate = PipelineState(1, 4)           # where the 6-step run stopped
    assert exp.sampler.plan(pstate, 6)[0].signature() == \
        fresh.sampler.plan(pstate, 6)[0].signature()


def test_refresh_scores_matches_reference():
    """``Sampler.refresh_scores`` scores ids through the engine and merges
    them into the store, as the reference's does, from the same params."""
    overrides = dict(BASE, **{"sampler.scheme": "history",
                              "imp.score_dtype": "float32"})
    jrun = jax_build_run("lm-tiny", preset="prod", overrides=overrides)
    prun = build_run("lm-tiny", preset="prod", overrides=overrides)
    vocab = jrun.model.vocab_size
    jexp = JaxExperiment(jrun, source=JaxSyntheticLM(vocab, 16, n_examples=N,
                                                     seed=jrun.seed))
    params = JaxLM(jrun.model).init(jax.random.PRNGKey(jrun.seed))
    exp = Experiment(prun, source=SyntheticLM(vocab, 16, n_examples=N,
                                              seed=prun.seed), device="cpu")
    interop.load_params(exp.lm, {k: np.asarray(v)
                                 for k, v in _flatten(params)[0].items()})
    gids = np.array([3, 9, 17, 19])
    assert jexp.sampler.refresh_scores(params, gids) == 4
    assert exp.sampler.refresh_scores(dict(exp.lm.named_parameters()),
                                      gids) == 4
    np.testing.assert_array_equal(exp.sampler.store.seen,
                                  jexp.sampler.store.seen)
    np.testing.assert_allclose(exp.sampler.store.scores,
                               jexp.sampler.store.scores, rtol=1e-5)
    # the blocking entry gives the bytes the refresh stored
    _, scores = exp.engine.score_host(dict(exp.lm.named_parameters()),
                                      exp.source.gather(gids))
    np.testing.assert_array_equal(exp.sampler.store.scores[gids], scores)


def test_is_disabled_runs_uniform_like_reference():
    (exp, hist, plans), (jexp, jhist, jplans) = _run_both(
        {"sampler.scheme": "history", "imp.enabled": False})
    assert exp.sampler.scheme == jexp.sampler.scheme == "uniform"
    for (g, w, _), (jg, jw, _) in zip(plans, jplans):
        np.testing.assert_array_equal(g, jg)
        assert w is None and jw is None
    for m, jm in zip(hist, jhist):
        np.testing.assert_allclose(m["loss"], jm["loss"], atol=LOSS_TOL,
                                   rtol=0)


def test_launcher_runs_history_sharded_on_cpu(capsys):
    from repro_torch.launch import train as launcher
    launcher.main(["--arch", "lm-tiny", "--preset", "prod", "--device",
                   "cpu", "--sampler.scheme=history",
                   "--imp.selection_impl=sharded", "--shape.seq_len=16",
                   "--shape.global_batch=2", "--steps=2",
                   "--obs.enabled=false"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 2
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)


ROUTES = [
    {"sampler.scheme": "history"},
    {"sampler.scheme": "history", "imp.enabled": False},
    {"sampler.scheme": "selective", "imp.selection_impl": "gather"},
    {"sampler.scheme": "uniform"},
    {"sampler.scheme": "presample", "imp.presample_impl": "host"},
    {"sampler.scheme": "presample", "imp.presample_impl": "step"},
    {"sampler.scheme": "presample", "imp.presample_impl": "auto",
     "sampler.host_score": True},
    {"sampler.scheme": "presample", "imp.presample_impl": "step",
     "imp.enabled": False},
]
BAD = [
    {"imp.selection_impl": "bogus"},
    {"imp.presample_impl": "bogus"},
    {"imp.score_prune": "bogus"},
    {"sampler.scheme": "bogus"},
    {"sampler.scheme": "history", "imp.selection_impl": "sharded",
     "shape.global_batch": 64},                       # n <= b
    {"sampler.scheme": "selective", "sampler.selective_window": 2},
]


@pytest.mark.parametrize("overrides", ROUTES + BAD)
def test_make_sampler_routes_and_validates_like_reference(overrides):
    """``make_sampler`` picks the reference's scheme and selection impl,
    and refuses what the reference refuses (on a 64-example source)."""
    from repro.sampler import make_sampler as jax_make_sampler
    from repro_torch.sampler import make_sampler
    overrides = dict(BASE, **overrides)
    jrun = jax_build_run("lm-tiny", preset="prod", overrides=overrides)
    prun = build_run("lm-tiny", preset="prod", overrides=overrides)
    jsrc = JaxSyntheticLM(512, 16, n_examples=64, seed=0)
    psrc = SyntheticLM(512, 16, n_examples=64, seed=0)
    try:
        want = jax_make_sampler(jrun, jsrc)
    except ValueError:
        with pytest.raises(ValueError):
            make_sampler(prun, psrc)
        return
    got = make_sampler(prun, psrc)
    assert (got.scheme, got.impl, got.uses_score_step, got.fetch_size) == \
        (want.scheme, want.impl, want.uses_score_step, want.fetch_size)
