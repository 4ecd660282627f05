"""Every architecture the port carries, against the JAX package:

* each config module a copy of the reference's, and ``ARCHS`` every
  dense-attention architecture of the reference with token input;
* ``reduced(arch, repeats=2)`` initialised in JAX and loaded through
  ``interop``: logits and loss to 1e-5 (f32), as
  ``tests/test_arch_smoke.py`` runs the reference's;
* ``models.counting``: the analytic parameter counts of all twelve
  reference configs (the function is duck-typed over the config), and
  ``ModelConfig.param_count`` / ``active_param_count``;
* one ``prod`` step of ``reduced(gemma3-12b, repeats=2)`` (window 64):
  plans bitwise, the loss to 1e-4, as ``tests/test_torch_slice.py`` holds
  lm-tiny;
* a gemma3 checkpoint (every pattern position's stacked leaves) written by
  either package's ``Checkpointer`` and read by the other;
* the block kinds still to port raise, naming their slice.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Experiment as JaxExperiment  # noqa: E402
from repro.api import Hook as JaxHook  # noqa: E402
from repro.api import build_run as jax_build_run  # noqa: E402
from repro.checkpoint.ckpt import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import counting as jax_counting  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.api import Experiment, Hook, build_run  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.checkpoint.ckpt import Checkpointer  # noqa: E402
from repro_torch.configs import (ARCHS, Segment, get_config,  # noqa: E402
                                 reduced)
from repro_torch.models import counting  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ATOL = 1e-5      # f32 on both sides; sums differ in order only
LOSS_TOL = 1e-4  # a train step's loss, as tests/test_torch_slice.py
DENSE = ("attn", "attn_local")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread, so the parallel test
    workers that share the host's cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_archs_are_the_dense_attention_token_archs():
    want = tuple(a for a in JAX_ARCHS
                 if jax_get_config(a).input_mode == "tokens"
                 and not jax_get_config(a).moe.n_experts
                 and set(jax_get_config(a).block_kinds) <= set(DENSE))
    assert ARCHS == want


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_and_counts_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_count_params_equals_reference(arch):
    """All twelve reference configs, through the port's copy of the
    arithmetic, total and active (MoE)."""
    jcfg = jax_get_config(arch)
    for active in (False, True):
        assert counting.count_params(jcfg, active_only=active) == \
            jax_counting.count_params(jcfg, active_only=active)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_and_loss_match_reference(arch):
    jcfg = jax_reduced(jax_get_config(arch), repeats=2)
    cfg = reduced(get_config(arch), repeats=2)
    jlm = JaxLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    flat, _ = _flatten(params)
    lm = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in flat.items()}, cfg, "cpu")
    assert sum(p.numel() for p in lm.parameters()) == cfg.param_count()
    rng = np.random.default_rng(len(arch))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 40)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 40))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jloss, _ = jlm.loss(params, jb, remat=False)
    want, _ = jlm.logits(params, jb)
    loss, _ = lm.loss(tb, remat=False)
    got = lm(tb).detach()
    assert got.shape == (2, 40, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL,
                               rtol=0)


def _gemma_params():
    cfg = reduced(get_config("gemma3-12b"), repeats=2)
    jcfg = jax_reduced(jax_get_config("gemma3-12b"), repeats=2)
    params = JaxLM(jcfg).init(jax.random.PRNGKey(3))
    return cfg, params


def test_gemma3_checkpoint_crosses_both_ways(tmp_path):
    """A reference checkpoint of reduced gemma3's params restores into the
    port's ``LM`` (``interop.stacked`` over every pattern position), and the
    port's checkpoint of them restores into the reference's tree: bitwise
    both ways, keys ``segments/seg0/stacked/p<i>/...`` for i in 0..5."""
    cfg, params = _gemma_params()
    flat, _ = _flatten(params)
    keys = {k for k in flat if k.startswith("segments/seg0/stacked/")}
    assert {k.split("/")[3] for k in keys} == {f"p{i}" for i in range(6)}
    JaxCheckpointer(tmp_path / "j").save(1, {"params": params})
    lm = LM(cfg, "cpu")
    tmpl = {"params": interop.stacked(dict(lm.named_parameters()))}
    Checkpointer(tmp_path / "j").restore(tmpl)
    got = interop.params_to_numpy(lm)
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    assert np.array_equal(
        lm.segments["seg0"].stacked["p3"][1].inner.wq.detach().numpy(),
        np.asarray(flat["segments/seg0/stacked/p3/inner/wq"])[1])

    Checkpointer(tmp_path / "p").save(
        2, {"params": interop.stacked(dict(lm.named_parameters()))})
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    back, step = JaxCheckpointer(tmp_path / "p").restore({"params": zeros})
    assert step == 2
    bflat, _ = _flatten(back["params"])
    assert set(bflat) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(np.asarray(bflat[k]), np.asarray(v),
                                      err_msg=k)


def _recorder(base):
    class Plans(base):
        def __init__(self):
            self.plans = []

        def on_step_start(self, loop, step, batch, meta):
            self.plans.append((np.array(meta.gids), None if meta.weights
                               is None else np.array(meta.weights)))
    return Plans()


def test_gemma3_prod_step_matches_reference():
    """One ``prod`` step (fused, survival-pruned presample; the gate
    lowered so importance sampling is on) from the same params: the plan's
    gids bitwise, its weights to float32 rounding, the loss to 1e-4."""
    overrides = {"shape.seq_len": 32, "shape.global_batch": 4, "steps": 1,
                 "obs.enabled": False, "imp.score_dtype": "float32",
                 "imp.tau_th": 1.01}
    jrun = jax_build_run(preset="prod", overrides=overrides,
                         model=jax_reduced(jax_get_config("gemma3-12b"),
                                           repeats=2))
    prun = build_run(preset="prod", overrides=overrides,
                     model=reduced(get_config("gemma3-12b"), repeats=2))
    jrec, prec = _recorder(JaxHook), _recorder(Hook)
    jexp = JaxExperiment(jrun)
    _, jhist = jexp.fit(hooks=[jrec])
    flat, _ = _flatten(JaxLM(jrun.model).init(jax.random.PRNGKey(jrun.seed)))
    exp = Experiment(prun, device="cpu")
    interop.load_params(exp.lm, {k: np.asarray(v) for k, v in flat.items()})
    _, hist = exp.fit(hooks=[prec])
    assert len(hist) == len(jhist) == 1
    (g, w), (jg, jw) = prec.plans[0], jrec.plans[0]
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_allclose(w, jw, rtol=1e-6, atol=0)
    np.testing.assert_allclose(hist[0]["loss"], jhist[0]["loss"],
                               atol=LOSS_TOL, rtol=0)


@pytest.mark.parametrize("arch,match", [
    ("deepseek-v2-236b", "MLA slice"),
    ("granite-moe-3b-a800m", "MoE slice"),
    ("zamba2-1.2b", "SSM slice"),
    ("xlstm-350m", "xLSTM slice"),
])
def test_unported_block_kinds_raise(arch, match):
    """The reference's layer pattern (and experts) on the port's lm-tiny."""
    jcfg = jax_get_config(arch)
    cfg = dataclasses.replace(
        get_config("lm-tiny"),
        segments=tuple(Segment(tuple(s.pattern), 1, s.dense_ffn)
                       for s in jcfg.segments),
        moe=dataclasses.replace(get_config("lm-tiny").moe,
                                n_experts=min(jcfg.moe.n_experts, 4)))
    with pytest.raises(NotImplementedError, match=match):
        LM(cfg, "cpu")
    with pytest.raises(ValueError, match="not ported yet"):
        get_config(arch)
