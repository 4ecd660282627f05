"""One ``StepSpec("host")`` AdamW step of the port against the JAX step,
lm-tiny f32, same params (through the checkpoint format), same batch,
weights and ``is_flag``: loss, per-sample scores, the τ controller and the
updated params within 1e-5, and each tensor's update within 1e-3 of its
norm."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import (ISConfig as JISConfig,  # noqa: E402
                                OptimConfig as JOptimConfig,
                                RunConfig as JRunConfig,
                                ShapeConfig as JShapeConfig)
from repro.core.is_train import StepSpec as JStepSpec  # noqa: E402
from repro.core.is_train import build_step as jax_build_step  # noqa: E402
from repro.core.is_train import train_state_init as jax_state  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.optim.api import get_optimizer as jax_opt  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (ISConfig, OptimConfig,  # noqa: E402
                                      RunConfig, ShapeConfig)
from repro_torch.core.is_train import (StepSpec, build_step,  # noqa: E402
                                       train_state_init)
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim.api import get_optimizer  # noqa: E402

TOL = 1e-5
UPD_RTOL = 1e-3   # per tensor, |Δ_port − Δ_jax| / |Δ_jax| (L2)
V0 = 1e-6         # warm AdamW second moment (see below)


def _runs(remat, score_by, boost):
    common = dict(steps=1, remat=remat)
    shape = dict(name="t", seq_len=32, global_batch=4, kind="train")
    optim = dict(name="adamw", lr=3e-4)      # the prod preset's optimizer
    imp = dict(score_by=score_by, lr_tau_boost_cap=boost)
    j = JRunConfig(model=jax_get_config("lm-tiny"), shape=JShapeConfig(**shape),
                   optim=JOptimConfig(**optim), imp=JISConfig(**imp), **common)
    p = RunConfig(model=get_config("lm-tiny"), shape=ShapeConfig(**shape),
                  optim=OptimConfig(**optim), imp=ISConfig(**imp), **common)
    return j, p


def _batch(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (4, 32)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[1, -5:] = -1
    return {"tokens": toks, "labels": labels,
            "weights": rng.uniform(0.5, 2.0, 4).astype(np.float32)}


@pytest.mark.parametrize("remat,is_flag,score_by,boost", [
    (True, 0.0, "upper-bound", 0.0),     # uniform-drawn batch
    (False, 2.5, "upper-bound", 0.0),    # IS-drawn: τ frozen, weights on
    (True, 2.5, "loss", 1.5),            # loss scores + the lr τ-boost
])
def test_host_step_matches_reference(remat, is_flag, score_by, boost):
    jrun, prun = _runs(remat, score_by, boost)
    jlm = JaxLM(jrun.model)
    params = jlm.init(jax.random.PRNGKey(1))
    flat, _ = _flatten(params)
    lm = interop.params_from_numpy({k: np.asarray(v) for k, v in flat.items()},
                                   prun.model, "cpu")
    batch = _batch(int(is_flag * 10) + remat)

    jopt = jax_opt(jrun.optim)
    jstate = jax_state(jlm, jopt, jax.random.PRNGKey(0), params=params)
    jstep = jax.jit(jax_build_step(jlm, jrun, jopt, JStepSpec("host")))
    # a non-zero τ EMA so the controller's EMA/freeze branch is exercised,
    # and warm second moments: on a cold first step AdamW's g/(|g|+eps)
    # turns a last-ulp gradient difference at |g| ~ eps into a visible
    # update difference, on any two implementations. V0 is small enough
    # that every tensor's largest update (≈ 2e-4) stays well above TOL.
    jstate["ctrl"] = jstate["ctrl"]._replace(tau_ema=jnp.float32(1.3))
    jstate["opt"]["v"] = jax.tree_util.tree_map(
        lambda v: jnp.full_like(v, V0), jstate["opt"]["v"])
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                     jnp.float32(is_flag))

    opt = get_optimizer(prun.optim)
    state = train_state_init(lm, opt)
    state["ctrl"] = state["ctrl"]._replace(tau_ema=torch.tensor(1.3))
    for v in state["opt"]["v"].values():
        v.fill_(V0)
    step = build_step(lm, prun, opt, StepSpec("host"))
    new, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  is_flag)

    for key in ("loss", "tau", "is_active", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=TOL,
                                   rtol=TOL, err_msg=key)
    np.testing.assert_allclose(m["sample_scores"].numpy(),
                               np.asarray(jm["sample_scores"]), atol=TOL,
                               rtol=TOL)
    assert new["step"] == int(jnew["step"]) == 1
    want, _ = _flatten(jnew["params"])
    got = interop.params_to_numpy(lm)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=TOL,
                                   rtol=0, err_msg=k)
    # the update itself, tensor by tensor: its f32 rounding at |p| ~ 1 is
    # ~ 1e-4 of it, so UPD_RTOL holds the update's direction and size
    for k in want:
        old = np.asarray(flat[k], np.float64)
        d_jax = np.asarray(want[k], np.float64) - old
        d_port = got[k].astype(np.float64) - old
        assert np.abs(d_jax).max() > 10 * TOL, k
        assert (np.linalg.norm(d_port - d_jax)
                <= UPD_RTOL * np.linalg.norm(d_jax)), k


def test_unported_step_kinds_raise():
    """Every step kind and both optimizers are ported; what the reference
    rejects, the port rejects as it does: an unknown kind or gate, an
    unknown optimizer (``ValueError``, as ``repro.optim.api``)."""
    _, prun = _runs(False, "upper-bound", 0.0)
    lm = LM(prun.model, "cpu")
    opt = get_optimizer(prun.optim)
    for spec in (StepSpec("presample", gate="never"), StepSpec("plain")):
        assert callable(build_step(lm, prun, opt, spec))
    for bad in (dict(kind="sampled"), dict(kind="presample", gate="maybe")):
        with pytest.raises(ValueError, match="unknown StepSpec"):
            StepSpec(**bad)
    assert callable(get_optimizer(dataclasses.replace(prun.optim,
                                                      name="sgd")).update)
    with pytest.raises(ValueError, match="lamb"):
        get_optimizer(dataclasses.replace(prun.optim, name="lamb"))
