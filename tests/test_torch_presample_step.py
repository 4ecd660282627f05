"""Algorithm 1 inside the step: the port's ``presample`` and ``plain`` step
kinds, SGD and its schedules, the draw and its weights, ``SyntheticCLS``,
and the presets that run them, against the JAX package at lm-tiny f32
(the same params through the checkpoint format, the same batches).

The reference draws the IS branch's indices with ``fold_in`` +
``categorical``, which torch cannot reproduce bit for bit, so the parity
cases compute JAX's indices outside its jit and hand the same indices to
the port by patching ``repro_torch.core.importance.sample_with_replacement``.
Held: the loss to 1e-4; τ, ``is_active`` and the B-vector of scores (with
its −1 entries) to 1e-5; each tensor's update to 1e-3 of its norm
(``UPD_RTOL``, as in ``test_torch_step.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import (ISConfig as JISConfig,  # noqa: E402
                                OptimConfig as JOptimConfig,
                                RunConfig as JRunConfig,
                                ShapeConfig as JShapeConfig)
from repro.core import importance as jimp  # noqa: E402
from repro.core.is_train import StepSpec as JStepSpec  # noqa: E402
from repro.core.is_train import build_step as jax_build_step  # noqa: E402
from repro.core.is_train import train_state_init as jax_state  # noqa: E402
from repro.data.pipeline import SyntheticCLS as JaxCLS  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.optim import api as jax_optim  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (ISConfig, OptimConfig,  # noqa: E402
                                      RunConfig, ShapeConfig)
from repro_torch.core import importance as imp  # noqa: E402
from repro_torch.core.is_train import (StepSpec, build_step,  # noqa: E402
                                       train_state_init)
from repro_torch.data.pipeline import SyntheticCLS  # noqa: E402
from repro_torch.optim import api as optim  # noqa: E402

LOSS_TOL = 1e-4
TOL = 1e-5
UPD_RTOL = 1e-3   # per tensor, |Δ_port − Δ_jax| / |Δ_jax| (L2)
b, RATIO, SEQ = 4, 3, 32
B = b * RATIO


def _runs(score_by="upper-bound", micro=1, boost=0.0, optim_kw=None):
    common = dict(steps=1, remat=False, microbatches=micro)
    shape = dict(name="t", seq_len=SEQ, global_batch=b, kind="train")
    okw = dict(name="sgd", lr=0.1) if optim_kw is None else optim_kw
    ikw = dict(presample_ratio=RATIO, score_by=score_by,
               lr_tau_boost_cap=boost)
    j = JRunConfig(model=jax_get_config("lm-tiny"),
                   shape=JShapeConfig(**shape), optim=JOptimConfig(**okw),
                   imp=JISConfig(**ikw), **common)
    p = RunConfig(model=get_config("lm-tiny"), shape=ShapeConfig(**shape),
                  optim=OptimConfig(**okw), imp=ISConfig(**ikw), **common)
    return j, p


def _pool(seed, rows=B):
    """A pool of ``rows`` candidates with uneven difficulty (some rows a
    repeated motif, some noise) and unsupervised tails."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (rows, SEQ)).astype(np.int32)
    toks[::3] = np.tile(toks[0, :4], SEQ // 4)
    labels = np.roll(toks, -1, axis=1)
    labels[1, -5:] = -1
    labels[rows - 2, -9:] = -1
    return {"tokens": toks, "labels": labels}


def _models(jrun, prun, seed=1):
    jlm = JaxLM(jrun.model)
    params = jlm.init(jax.random.PRNGKey(seed))
    flat, _ = _flatten(params)
    flat = {k: np.asarray(v) for k, v in flat.items()}
    return jlm, params, flat, interop.params_from_numpy(flat, prun.model,
                                                        "cpu")


def _jax_is_indices(jlm, jrun, params, batch, step=0):
    """The indices the reference's IS branch draws: fold_in(PRNGKey(0),
    step) and ``sample_with_replacement`` over g of the same scores."""
    loss_ps, scores = jlm.sample_stats(params, batch,
                                       score_impl=jrun.imp.score_impl)
    if jrun.imp.score_by == "loss":
        scores = loss_ps
    g = jimp.normalize_scores(scores)
    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    return np.asarray(jimp.sample_with_replacement(key, g, b))


def _check_updates(lm, flat, jparams):
    want, _ = _flatten(jparams)
    got = interop.params_to_numpy(lm)
    for k in want:
        old = np.asarray(flat[k], np.float64)
        d_jax = np.asarray(want[k], np.float64) - old
        d_port = got[k].astype(np.float64) - old
        assert np.abs(d_jax).max() > 0, k
        assert (np.linalg.norm(d_port - d_jax)
                <= UPD_RTOL * np.linalg.norm(d_jax)), k


def _run_both(spec, jrun, prun, batch, tau_ema, monkeypatch, inject=True):
    jlm, params, flat, lm = _models(jrun, prun)
    jopt = jax_optim.get_optimizer(jrun.optim)
    jstate = jax_state(jlm, jopt, jax.random.PRNGKey(0), params=params)
    jstate["ctrl"] = jstate["ctrl"]._replace(tau_ema=jnp.float32(tau_ema))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(jax_build_step(jlm, jrun, jopt, JStepSpec(*spec)))
    jnew, jm = jstep(jstate, jbatch)

    drawn = []
    if inject:
        idx = _jax_is_indices(jlm, jrun, params, jbatch)

        def draw(generator, g, n):
            assert n == b and g.shape == (B,)
            assert abs(float(g.sum()) - 1.0) < 1e-5
            drawn.append(idx)
            return torch.from_numpy(idx.astype(np.int64))
        monkeypatch.setattr(imp, "sample_with_replacement", draw)
    opt = optim.get_optimizer(prun.optim)
    state = train_state_init(lm, opt)
    state["ctrl"] = state["ctrl"]._replace(tau_ema=torch.tensor(tau_ema))
    step = build_step(lm, prun, opt, StepSpec(*spec))
    new, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return lm, flat, jnew, jm, new, m, drawn


@pytest.mark.parametrize("gate,tau_ema,score_by,micro,boost", [
    ("never", 1.3, "upper-bound", 1, 0.0),
    ("always", 1.3, "upper-bound", 1, 0.0),
    ("cond", 2.5, "upper-bound", 1, 0.0),   # τ̂ above τ_th = 2: IS
    ("cond", 1.3, "upper-bound", 1, 0.0),   # below: uniform
    ("always", 1.3, "loss", 1, 0.0),
    ("never", 1.3, "loss", 1, 0.0),
    ("always", 2.5, "upper-bound", 2, 1.5),  # microbatches + lr τ-boost
    ("never", 1.3, "upper-bound", 2, 0.0),
])
def test_presample_step_matches_reference(gate, tau_ema, score_by, micro,
                                          boost, monkeypatch):
    jrun, prun = _runs(score_by, micro, boost)
    assert prun.imp.resolved_tau_th(b) == jrun.imp.resolved_tau_th(b) == 2.0
    lm, flat, jnew, jm, new, m, drawn = _run_both(
        ("presample", gate), jrun, prun, _pool(7 + micro), tau_ema,
        monkeypatch)
    is_branch = gate == "always" or (gate == "cond" and tau_ema > 2.0)
    assert float(jm["is_active"]) == m["is_active"] == float(is_branch)
    assert len(drawn) == int(is_branch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=LOSS_TOL, rtol=0)
    for key in ("tau", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=TOL,
                                   rtol=TOL, err_msg=key)
    sc, jsc = m["sample_scores"].numpy(), np.asarray(jm["sample_scores"])
    assert sc.shape == jsc.shape == (B,)
    np.testing.assert_array_equal(sc < 0, jsc < 0)
    assert int((sc < 0).sum()) == (0 if is_branch else B - b)
    np.testing.assert_allclose(sc, jsc, atol=TOL, rtol=TOL)
    assert new["step"] == int(jnew["step"]) == 1
    assert int(new["ctrl"].steps_is) == int(jnew["ctrl"].steps_is)
    _check_updates(lm, flat, jnew["params"])


def test_plain_step_matches_reference():
    jrun, prun = _runs()
    batch = _pool(3, rows=b)
    lm, flat, jnew, jm, new, m, _ = _run_both(("plain",), jrun, prun, batch,
                                              0.0, None, inject=False)
    assert set(m) == {"loss", "grad_norm", "lr"}
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=LOSS_TOL, rtol=0)
    _check_updates(lm, flat, jnew["params"])


@pytest.mark.parametrize("nesterov,clip,wd", [(False, 1.0, 5e-4),
                                              (True, 1.0, 5e-4),
                                              (False, 0.0, 0.0),
                                              (True, 0.0, 1e-2)])
def test_sgd_matches_reference(nesterov, clip, wd):
    """Three SGD updates of a small parameter dict (one bf16 leaf) from the
    same gradients, under the paper's step-drop schedule."""
    cfg = dict(name="sgd", lr=0.1, momentum=0.9, nesterov=nesterov,
               weight_decay=wd, grad_clip=clip)
    rng = np.random.default_rng(int(nesterov) + 2 * int(clip > 0))
    shapes = {"w": (5, 7), "b": (7,), "e": (3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    sched = dict(lr=0.1, drops=(1, 2), factor=0.2)
    jopt = jax_optim.get_optimizer(JOptimConfig(**cfg),
                                   jax_optim.step_drop_schedule(**sched))
    opt = optim.get_optimizer(OptimConfig(**cfg),
                              optim.step_drop_schedule(**sched))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp["e"] = jp["e"].astype(jnp.bfloat16)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tp["e"] = tp["e"].to(torch.bfloat16)
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) * 3.0
                 for k, s in shapes.items()}
        jp, js, jm = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                 js, jp, jnp.int32(step))
        tp, ts, m = opt.update({k: torch.from_numpy(v)
                                for k, v in grads.items()}, ts, tp, step)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6)
        for k in shapes:
            assert tp[k].dtype == (torch.bfloat16 if k == "e"
                                   else torch.float32)
            np.testing.assert_allclose(ts["master"][k].numpy(),
                                       np.asarray(js["master"][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(ts["mu"][k].numpy(),
                                       np.asarray(js["mu"][k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            # the cast back to the parameter's dtype: a master a last ulp
            # apart may round to the neighbouring bf16 value
            np.testing.assert_allclose(
                tp[k].float().numpy(), np.asarray(jp[k].astype(jnp.float32)),
                rtol=2 ** -8 if k == "e" else 1e-5, atol=1e-6, err_msg=k)


def test_schedules_match_reference():
    cases = [(optim.step_drop_schedule(0.1, (3, 7), 0.2),
              jax_optim.step_drop_schedule(0.1, (3, 7), 0.2)),
             (optim.warmup_cosine_schedule(3e-4, 5, 40),
              jax_optim.warmup_cosine_schedule(3e-4, 5, 40)),
             (optim.warmup_cosine_schedule(1e-3, 0, 10),
              jax_optim.warmup_cosine_schedule(1e-3, 0, 10))]
    for ours, theirs in cases:
        for step in range(0, 45):
            np.testing.assert_allclose(float(ours(step)),
                                       float(theirs(jnp.int32(step))),
                                       rtol=1e-6, atol=1e-12,
                                       err_msg=str(step))


def test_draw_and_weights_are_unbiased():
    """Monte Carlo: b-of-B draws ∝ g with weights 1/(B·g) estimate the
    uniform mean of any per-sample quantity without bias; the draw's
    frequencies follow g."""
    rng = np.random.default_rng(0)
    n, draws = 16, 400_000
    x = torch.from_numpy(rng.normal(size=n).astype(np.float64))
    g = imp.normalize_scores(torch.from_numpy(
        rng.lognormal(0.0, 1.0, n).astype(np.float32)))
    gen = torch.Generator().manual_seed(1)
    idx = imp.sample_with_replacement(gen, g, draws)
    assert idx.shape == (draws,) and idx.dtype == torch.int64
    w = imp.unbiased_weights(g, idx).double()
    est = w * x[idx]
    se = float(est.std()) / draws ** 0.5
    assert abs(float(est.mean()) - float(x.mean())) < 5 * se
    assert abs(float(w.mean()) - 1.0) < 5 * float(w.std()) / draws ** 0.5
    freq = torch.bincount(idx, minlength=n).double() / draws
    sd = (g.double() * (1 - g.double()) / draws).sqrt()
    assert bool(((freq - g.double()).abs() < 5 * sd).all())
    # the weights and the §3.3 quantities are the reference's
    np.testing.assert_allclose(
        imp.unbiased_weights(g, idx[:50]).numpy(),
        np.asarray(jimp.unbiased_weights(jnp.asarray(g.numpy()),
                                         jnp.asarray(idx[:50].numpy()))),
        rtol=1e-6)
    gn = torch.from_numpy(rng.lognormal(0.0, 1.0, 12).astype(np.float32))
    np.testing.assert_allclose(
        float(imp.variance_reduction(gn)),
        float(jimp.variance_reduction(jnp.asarray(gn.numpy()))), rtol=1e-5)
    for Bn, bn, t in ((12, 4, 2.5), (12, 4, 1.5), (30, 10, 1.34)):
        assert imp.speedup_guaranteed(t, Bn, bn) == \
            bool(jimp.speedup_guaranteed(t, Bn, bn))
        assert imp.max_speedup(Bn, bn) == jimp.max_speedup(Bn, bn)
        assert imp.max_variance_reduction(Bn, bn) == \
            jimp.max_variance_reduction(Bn, bn)


@pytest.mark.parametrize("epoch", [0, 3])
def test_synthetic_cls_bitwise_reference(epoch):
    ours = SyntheticCLS(512, 16, seed=5)
    theirs = JaxCLS(512, 16, seed=5)
    ids = np.array([0, 1, 2, 3, 17, 999, 16383, 16384 + 7])
    a, bt = ours.gather(ids, epoch=epoch), theirs.gather(ids, epoch=epoch)
    assert set(a) == set(bt) == {"tokens", "labels"}
    for k in a:
        assert a[k].dtype == bt[k].dtype
        np.testing.assert_array_equal(a[k], bt[k])
    assert (a["labels"][:, :-1] == -1).all()


def test_smoke_preset_trains_on_cpu():
    """The ``smoke`` preset — the default spelling of Algorithm 1 (the
    ``presample`` step kind, τ-gated) — end to end, and the same run's
    losses as the JAX package's from the same params."""
    from repro.api import Experiment as JaxExperiment
    from repro.api import build_run as jax_build_run
    _, hist = repro_torch.train("lm-tiny", preset="smoke", device="cpu")
    assert len(hist) == 20
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    overrides = {"steps": 5}
    jexp = JaxExperiment(jax_build_run("lm-tiny", preset="smoke",
                                       overrides=overrides))
    _, jhist = jexp.fit()
    exp = repro_torch.Experiment(repro_torch.build_run(
        "lm-tiny", preset="smoke", overrides=overrides), device="cpu")
    assert exp.step_is_flagged is False
    params = JaxLM(jexp.run.model).init(jax.random.PRNGKey(exp.run.seed))
    flat, _ = _flatten(params)
    interop.load_params(exp.lm, {k: np.asarray(v) for k, v in flat.items()})
    _, phist = exp.fit()
    for m, jm in zip(phist, jhist):
        assert m["is_active"] == jm["is_active"] == 0.0
        np.testing.assert_allclose(m["loss"], jm["loss"], atol=LOSS_TOL,
                                   rtol=0)
        np.testing.assert_allclose(m["tau"], jm["tau"], atol=LOSS_TOL)
    # the uniform branch's b scores reached the score memory, the −1 pads
    # did not
    np.testing.assert_array_equal(exp.sampler.store.seen,
                                  jexp.sampler.store.seen)
    np.testing.assert_allclose(exp.sampler.store.scores,
                               jexp.sampler.store.scores, rtol=1e-4)


def test_quickstart_switches_importance_sampling_on():
    """``paper_cifar`` on the ``cls`` source with a callback — the
    quickstart: the τ gate opens within its 120 steps."""
    seen = []
    _, hist = repro_torch.train("lm-tiny", preset="paper_cifar",
                                source="cls", device="cpu",
                                callback=lambda i, m: seen.append(
                                    (i, m["is_active"])))
    assert [i for i, _ in seen] == list(range(120))
    assert len(hist) == 120
    assert any(a == 1.0 for _, a in seen), "IS never switched on"
    first = next(i for i, a in seen if a == 1.0)
    assert hist[first - 1]["tau"] > 1.3      # the gate read τ̂ > τ_th
    assert all(np.isfinite(h["loss"]) for h in hist)
