"""The input modes against the JAX package: ``"embeddings"``
(musicgen-medium: frame embeddings in, no ``embed`` parameter, the
ungated GELU MLP, an untied head) and ``"tokens+image"`` (llava-next-34b:
image embeddings before the text, whose positions carry no loss), at
``reduced(arch, repeats=2)`` in f32 with the same parameters (through the
checkpoint format) and the same seeded numpy inputs. Held:

* logits and loss to 1e-5, and the gradient of every leaf;
* ``sample_stats`` to 1e-5, and ``pool_stats_pruned`` with the same
  selection context and k: the alive rows equal, the scores to 1e-6;
* one in-step ``presample`` step (``gate="always"``) with the reference's
  indices injected, as ``tests/test_torch_presample_step.py`` does: the
  loss to 1e-4, the B scores to 1e-5, each tensor's update to 1e-3 of its
  norm;
* serve: musicgen's prefill of embeddings, then 3 decode steps of
  embeddings; llava's image + text prefill, then 3 text decode steps (the
  reference's own test skips llava's serve; its ``serve_step`` runs it):
  the last-position logits of each step to 1e-5;
* a musicgen checkpoint written by either package and read by the other.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import (ISConfig as JISConfig,  # noqa: E402
                                OptimConfig as JOptimConfig,
                                RunConfig as JRunConfig,
                                ShapeConfig as JShapeConfig)
from repro.core import importance as jimp  # noqa: E402
from repro.core.is_train import StepSpec as JStepSpec  # noqa: E402
from repro.core.is_train import build_step as jax_build_step  # noqa: E402
from repro.core.is_train import train_state_init as jax_state  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.optim import api as jax_optim  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.checkpoint.ckpt import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import (ISConfig, OptimConfig,  # noqa: E402
                                      RunConfig, ShapeConfig)
from repro_torch.core import importance as imp  # noqa: E402
from repro_torch.core.is_train import (StepSpec, build_step,  # noqa: E402
                                       train_state_init)
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import api as optim  # noqa: E402

ATOL = 1e-5
SCORE_TOL = 1e-6
LOSS_TOL = 1e-4
UPD_RTOL = 1e-3
ARCHS = ("musicgen-medium", "llava-next-34b")
b, RATIO = 4, 3
B = b * RATIO


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    flat, _ = _flatten(tree)
    return {k: np.asarray(v) for k, v in flat.items()}


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jcfg = jax_reduced(jax_get_config(arch), repeats=2)
        cfg = reduced(get_config(arch), repeats=2)
        jlm = JaxLM(jcfg)
        # under one jit: the eager init compiles every primitive anew
        params = jax.jit(jlm.init)(jax.random.PRNGKey(1))
        flat = _np(params)
        _MODELS[arch] = (jlm, params, flat,
                         interop.params_from_numpy(flat, cfg, "cpu"))
    return _MODELS[arch]


@functools.lru_cache(maxsize=None)
def _sample_stats(jlm):
    """The reference's ``sample_stats`` under one jit, one per model (its
    two callers here share the compile)."""
    return jax.jit(jlm.sample_stats)


def _batch(cfg, rows, s, seed):
    """A batch of the config's input mode with ``s`` positions in all (an
    image prefix of ``n_prefix_embeds`` included), labels of the text."""
    rng = np.random.default_rng(seed)
    out = {}
    n_img = cfg.n_prefix_embeds if cfg.input_mode == "tokens+image" else 0
    s_txt = s - n_img
    if cfg.input_mode == "embeddings":
        out["embeds"] = (rng.normal(size=(rows, s, cfg.d_model))
                         * 0.02).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (rows, s_txt)).astype(np.int32)
        out["image_embeds"] = (rng.normal(size=(rows, n_img, cfg.d_model))
                               * 0.02).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (rows, s_txt)).astype(np.int32)
    labels[1::3, -3:] = -1
    out["labels"] = labels
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_input_mode_configs():
    mg = get_config("musicgen-medium")
    assert mg.input_mode == "embeddings" and mg.act == "gelu"
    assert not mg.tie_embeddings
    lv = get_config("llava-next-34b")
    assert lv.input_mode == "tokens+image" and lv.n_prefix_embeds == 576
    _, _, flat, lm = _models("musicgen-medium")
    assert "embed" not in flat and "lm_head" in flat
    assert not any(k.endswith("w_gate") for k in flat)
    assert not hasattr(lm, "embed")
    _, _, flat, _ = _models("llava-next-34b")
    assert "embed" in flat and "lm_head" in flat


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_grads_match_reference(arch):
    jlm, params, flat, lm = _models(arch)
    batch = _batch(lm.cfg, 2, 40, seed=3)
    jb, tb = _j(batch), _t(batch)
    want, _ = jax.jit(jlm.logits)(params, jb)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, jb, remat=False), has_aux=True))(params)
    with torch.no_grad():
        got = lm(tb)
    assert got.shape == (2, 40, lm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    lm.zero_grad(set_to_none=True)
    loss, _ = lm.loss(tb, remat=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL,
                               rtol=0)
    gflat = _np(jgrads)
    named = dict(lm.named_parameters())
    assert {interop.jax_key(n) for n in named} == set(gflat)
    for name, p in named.items():
        key, layer = interop._split(name)
        w = gflat[key] if layer is None else gflat[key][layer]
        np.testing.assert_allclose(p.grad.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)
    lm.zero_grad(set_to_none=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_sample_stats_and_pruned_pool_match_reference(arch):
    jlm, params, flat, lm = _models(arch)
    batch = _batch(lm.cfg, B, 32, seed=5)
    jb, tb = _j(batch), _t(batch)
    jl, js = _sample_stats(jlm)(params, jb)
    pl, ps = lm.sample_stats(tb)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=ATOL, rtol=0)
    ctx, k = 0x9E3779B9, 3
    jl, js, ja, _ = jlm.pool_stats_pruned(params, jb, ctx, k=k)
    pl, ps, pa, _ = lm.pool_stats_pruned(tb, ctx, k=k)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    ja = np.asarray(ja).astype(bool)
    assert 0 < ja.sum() < B
    np.testing.assert_allclose(ps.numpy()[ja], np.asarray(js)[ja],
                               atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(pl.numpy()[ja], np.asarray(jl)[ja],
                               atol=SCORE_TOL, rtol=0)


def _runs(jcfg, cfg):
    common = dict(steps=1, remat=False)
    shape = dict(name="t", seq_len=32, global_batch=b, kind="train")
    okw = dict(name="sgd", lr=0.1)
    ikw = dict(presample_ratio=RATIO)
    j = JRunConfig(model=jcfg, shape=JShapeConfig(**shape),
                   optim=JOptimConfig(**okw), imp=JISConfig(**ikw), **common)
    p = RunConfig(model=cfg, shape=ShapeConfig(**shape),
                  optim=OptimConfig(**okw), imp=ISConfig(**ikw), **common)
    return j, p


@pytest.mark.parametrize("arch", ARCHS)
def test_presample_step_matches_reference(arch, monkeypatch):
    """The IS branch: the pool scored (the image prefix padded out of the
    labels), the reference's draw injected, the weighted update."""
    jlm, params, flat, _ = _models(arch)
    lm = interop.params_from_numpy(flat, reduced(get_config(arch),
                                                 repeats=2), "cpu")
    jrun, prun = _runs(jlm.cfg, lm.cfg)
    batch = _batch(lm.cfg, B, 32, seed=7)
    jb = _j(batch)
    _, scores = _sample_stats(jlm)(params, jb)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    idx = np.asarray(jimp.sample_with_replacement(
        key, jimp.normalize_scores(scores), b))
    jopt = jax_optim.get_optimizer(jrun.optim)
    jstate = jax_state(jlm, jopt, jax.random.PRNGKey(0), params=params)
    jstep = jax.jit(jax_build_step(jlm, jrun, jopt,
                                   JStepSpec("presample", "always")))
    jnew, jm = jstep(jstate, jb)

    drawn = []

    def draw(generator, g, n):
        assert n == b and g.shape == (B,)
        drawn.append(idx)
        return torch.from_numpy(idx.astype(np.int64))
    monkeypatch.setattr(imp, "sample_with_replacement", draw)
    opt = optim.get_optimizer(prun.optim)
    step = build_step(lm, prun, opt, StepSpec("presample", "always"))
    new, m = step(train_state_init(lm, opt), _t(batch))
    assert len(drawn) == 1 and float(jm["is_active"]) == m["is_active"] == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(m["sample_scores"].numpy(),
                               np.asarray(jm["sample_scores"]), atol=ATOL,
                               rtol=ATOL)
    want = _np(jnew["params"])
    got = interop.params_to_numpy(lm)
    for k in want:
        old = flat[k].astype(np.float64)
        d_jax = want[k].astype(np.float64) - old
        d_port = got[k].astype(np.float64) - old
        assert np.abs(d_jax).max() > 0, k
        assert (np.linalg.norm(d_port - d_jax)
                <= UPD_RTOL * np.linalg.norm(d_jax)), k


def _serve_steps(cfg, P, gen, seed):
    """(inputs, first position) of a prefill of P positions and ``gen``
    one-position decode steps: musicgen's embeddings throughout; llava's
    image prefix and text, then text."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    if cfg.input_mode == "embeddings":
        emb = lambda n: (rng.normal(size=(2, n, d)) * 0.02).astype(np.float32)
        steps = [({"embeds": emb(P)}, 0)]
        steps += [({"embeds": emb(1)}, P + i) for i in range(gen)]
        return steps
    n_img = cfg.n_prefix_embeds
    tok = lambda n: rng.integers(0, cfg.vocab_size, (2, n)).astype(np.int32)
    steps = [({"tokens": tok(P - n_img),
               "image_embeds": (rng.normal(size=(2, n_img, d))
                                * 0.02).astype(np.float32)}, 0)]
    steps += [({"tokens": tok(1)}, P + i) for i in range(gen)]
    return steps


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch):
    jlm, params, flat, lm = _models(arch)
    P, GEN, CAP = 14, 3, 24
    jc, pc, qc = jlm.caches(2, CAP), lm.caches(2, CAP), lm.caches(2, CAP)
    jstep = jax.jit(jlm.serve_step)
    with torch.inference_mode():
        for inputs, off in _serve_steps(lm.cfg, P, GEN, seed=9):
            n = P if off == 0 else 1
            pos = np.broadcast_to(np.arange(off, off + n,
                                            dtype=np.int32)[None], (2, n))
            want, jc = jstep(params, jc, dict(_j(inputs),
                                              positions=jnp.asarray(pos)))
            got, pc = lm.serve_step(pc, dict(
                _t(inputs), positions=torch.from_numpy(pos.copy())))
            got2, qc = lm.serve_step(qc, _t(inputs), q_offset=off)
            assert got.shape == (2, 1, lm.cfg.vocab_size)
            for g in (got, got2):
                np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                           atol=ATOL, rtol=0)
    filled = P + GEN
    pos = pc["seg0"]["p0"][1]["pos"]
    assert (pos[:, :filled].numpy() == np.arange(filled)).all()


def test_musicgen_checkpoint_crosses_both_ways(tmp_path):
    """The reference's checkpoint of reduced musicgen's params (no
    ``embed``, ``lm_head``, ungated ``w_up``/``w_down``) restores into the
    port's ``LM`` and the port's into the reference's tree, bitwise."""
    jlm, params, flat, _ = _models("musicgen-medium")
    JaxCheckpointer(tmp_path / "j").save(1, {"params": params})
    lm = LM(reduced(get_config("musicgen-medium"), repeats=2), "cpu")
    Checkpointer(tmp_path / "j").restore(
        {"params": interop.stacked(dict(lm.named_parameters()))})
    got = interop.params_to_numpy(lm)
    assert set(got) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    Checkpointer(tmp_path / "p").save(
        2, {"params": interop.stacked(dict(lm.named_parameters()))})
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    back, step = JaxCheckpointer(tmp_path / "p").restore({"params": zeros})
    assert step == 2
    bflat = _np(back["params"])
    assert set(bflat) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(bflat[k], v, err_msg=k)


def test_image_prefix_carries_no_loss():
    """The port's label pad: llava's loss equals the loss of the same
    logits with the first ``n_prefix_embeds`` positions dropped."""
    _, _, _, lm = _models("llava-next-34b")
    batch = _t(_batch(lm.cfg, 2, 24, seed=13))
    with torch.no_grad():
        loss, m = lm.loss(batch, remat=False)
        logits = lm(batch)[:, lm.cfg.n_prefix_embeds:]
        lbl = batch["labels"]
        ce = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), lbl.reshape(-1).long(),
            ignore_index=-1, reduction="none").reshape(lbl.shape)
        mask = (lbl >= 0).float()
        want = ((ce * mask).sum(-1) / mask.sum(-1)).mean()
    np.testing.assert_allclose(float(loss), float(want), atol=ATOL, rtol=0)
    assert float(m["tokens"]) == float(mask.sum())
    assert dataclasses.asdict(lm.cfg)["input_mode"] == "tokens+image"
