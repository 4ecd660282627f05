"""The paper's variance diagnostics (``repro_torch.core.variance``) against
``repro.core.variance``, f32, with the same parameters (through the
checkpoint format) and the same seeded numpy batches of B = 8 rows: a token
batch with unsupervised tails, and a ``SyntheticCLS``-style batch whose
loss sits on the final position only. Cases run at reduced lm-tiny and at
reduced granite-moe-3b-a800m, whose router aux enters every per-sample
gradient.

Held: ``per_sample_gradients`` column for column (the reference's leaf
order; 1e-5 absolute in units of the leaf's largest |gradient| where it
exceeds 1, and 1e-4 relative), the four ``sampling_distributions``
to 1e-6, ``correlation_sse`` to 1e-6, and ``grad_distance_reduction`` to
1e-5 relative with the reference's draws replayed: its
``sample_with_replacement`` calls are recorded in order, scheme by scheme
and round by round, and handed to the port's through
``repro_torch.core.importance``. The port's own draws (a
``torch.Generator``) give finite ratios with ``uniform`` exactly 1.

The reference's ``sampling_distributions`` recomputes the gradient matrix
(one ``lax.map`` trace and compile) and its forward on every call;
``_case`` computes the matrix once per arch, and the distributions once
per batch, which the reference's two callers read from a cache.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core import importance as jimp  # noqa: E402
from repro.core import variance as jvar  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import importance as imp  # noqa: E402
from repro_torch.core import variance  # noqa: E402

B, b, SEQ, ROUNDS = 8, 3, 16, 4
ARCHS = ("lm-tiny", "granite-moe-3b-a800m")
KINDS = ("tokens", "cls")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(kind, vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, SEQ)).astype(np.int32)
    if kind == "tokens":
        labels = np.roll(toks, -1, axis=1)
        labels[::3, -4:] = -1                     # unsupervised tails
    else:                                         # SyntheticCLS: last only
        toks[::2, :6] = toks[0, :6]               # uneven difficulty
        labels = np.full((B, SEQ), -1, np.int32)
        labels[:, -1] = rng.integers(0, 8, B)
    return {"tokens": toks, "labels": labels.astype(np.int32)}


_CASES = {}


def _case(arch, kind):
    """(port LM, batch, reference outputs) for one arch and batch kind. The
    reference's gradient matrix of both batch kinds comes from one
    ``per_sample_gradients`` over their 16 rows (its rows are independent);
    its ``sampling_distributions`` reads each kind's 8 rows of it."""
    if (arch, kind) in _CASES:
        return _CASES[arch, kind]
    jcfg = jax_reduced(jax_get_config(arch))
    jlm = JaxLM(jcfg)
    # under one jit: the eager init compiles every primitive anew
    params = jax.jit(jlm.init)(jax.random.PRNGKey(2))
    flat, _ = _flatten(params)
    lm = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in flat.items()},
        reduced(get_config(arch)), "cpu")
    batches = {k: _batch(k, jcfg.vocab_size, seed=len(arch) + len(k))
               for k in KINDS}
    both = {name: jnp.asarray(np.concatenate([batches[k][name]
                                              for k in KINDS]))
            for name in ("tokens", "labels")}
    all_grads = jvar.per_sample_gradients(jlm, params, both)
    real, real_draw = jvar.per_sample_gradients, jimp.sample_with_replacement
    real_dists = jvar.sampling_distributions
    for i, k in enumerate(KINDS):
        jb = {n: jnp.asarray(v) for n, v in batches[k].items()}
        grads = all_grads[i * B:(i + 1) * B]
        drawn, memo = [], []

        def cached(lm_, p_, batch_):
            assert batch_ is jb
            return grads

        def dists_once(lm_, p_, batch_):
            assert batch_ is jb
            if not memo:
                memo.append(real_dists(lm_, p_, batch_))
            return memo[0]

        def record(key, g, n):
            idx = real_draw(key, g, n)
            drawn.append(np.asarray(idx))
            return idx
        jvar.per_sample_gradients = cached
        jvar.sampling_distributions = dists_once
        jimp.sample_with_replacement = record
        try:
            sse, dists = jvar.correlation_sse(jlm, params, jb)
            ratios = jvar.grad_distance_reduction(
                jlm, params, jb, b, jax.random.PRNGKey(9), n_rounds=ROUNDS)
        finally:
            jvar.per_sample_gradients = real
            jvar.sampling_distributions = real_dists
            jimp.sample_with_replacement = real_draw
        tb = {n: torch.from_numpy(v) for n, v in batches[k].items()}
        _CASES[arch, k] = lm, tb, dict(
            grads=np.asarray(grads), sse=sse, ratios=ratios, drawn=drawn,
            dists={n: np.asarray(v) for n, v in dists.items()}, flat=flat)
    return _CASES[arch, kind]


CASES = [(a, k) for a in ARCHS for k in KINDS]


@pytest.mark.parametrize("arch,kind", CASES)
def test_per_sample_gradients_match_reference(arch, kind):
    lm, tb, want = _case(arch, kind)
    got = variance.per_sample_gradients(lm, tb).numpy()
    assert got.shape == want["grads"].shape
    assert got.shape[1] == sum(np.asarray(v).size
                               for v in want["flat"].values())
    at = 0
    for key, ts in variance.leaf_order(lm):
        n = sum(t.numel() for t in ts)
        g, w = got[:, at:at + n], want["grads"][:, at:at + n]
        # 1e-5 absolute in units of the leaf's largest |gradient| where it
        # exceeds 1: the embedding's rows sum terms of up to ~30 (the
        # input side of an RMSNorm over embeddings of std 0.02), whose f32
        # sums differ by order in the last bits of those terms
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=1e-5 * scale, rtol=1e-4,
                                   err_msg=key)
        if key.endswith("experts/w_down"):
            # the padded experts' columns are zero, as the reference's
            blk = g.reshape(B, len(ts), 48, -1)
            assert np.abs(blk[:, :, 4:]).max() == 0.0
            assert np.abs(blk[:, :, :4]).max() > 0.0
        at += n
    assert at == got.shape[1]


@pytest.mark.parametrize("arch,kind", CASES)
def test_sampling_distributions_and_sse_match_reference(arch, kind):
    lm, tb, want = _case(arch, kind)
    dists, grads = variance.sampling_distributions(lm, tb)
    assert list(dists) == list(want["dists"])
    for name, p in dists.items():
        np.testing.assert_allclose(p.numpy(), want["dists"][name], atol=1e-6,
                                   rtol=0, err_msg=name)
    sse, _ = variance.correlation_sse(lm, tb)
    assert set(sse) == set(want["sse"])
    for name, v in sse.items():
        np.testing.assert_allclose(v, want["sse"][name], atol=1e-6, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("arch,kind", CASES)
def test_grad_distance_reduction_with_reference_draws(arch, kind,
                                                      monkeypatch):
    lm, tb, want = _case(arch, kind)
    drawn = list(want["drawn"])
    assert len(drawn) == 4 * ROUNDS

    def replay(generator, g, n):
        assert n == b and g.shape == (B,)
        return torch.from_numpy(drawn.pop(0).astype(np.int64))
    monkeypatch.setattr(imp, "sample_with_replacement", replay)
    got = variance.grad_distance_reduction(lm, tb, b, None, n_rounds=ROUNDS)
    assert not drawn
    assert list(got) == list(want["ratios"])
    for name, v in got.items():
        np.testing.assert_allclose(v, want["ratios"][name], rtol=1e-5,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_distance_reduction_own_draws(arch):
    lm, tb, _ = _case(arch, "cls")
    gen = torch.Generator().manual_seed(0)
    got = variance.grad_distance_reduction(lm, tb, b, gen, n_rounds=ROUNDS)
    assert set(got) == {"uniform", "loss", "upper-bound", "gradient-norm"}
    assert got["uniform"] == 1.0
    assert all(np.isfinite(v) and v > 0 for v in got.values())
