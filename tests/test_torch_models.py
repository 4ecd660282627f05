"""The port's model against the JAX reference at lm-tiny size, f32, with
the same parameters (carried through the checkpoint format) and the same
seeded numpy inputs: logits through both plain attention branches and
the forward-only flash route, the four ``token_stats`` implementations,
and the per-sample loss/score."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402

ATOL = 1e-5      # f32 on both sides; sums differ in order only


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("lm-tiny")
    jlm = jax_lm.LM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    flat, _ = _flatten(params)
    lm = interop.params_from_numpy(
        {k: np.asarray(v) for k, v in flat.items()}, get_config("lm-tiny"),
        "cpu")
    return jlm, params, lm


def _batch(seq, b=2, vocab=512, seed=0, weights=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, seq)).astype(np.int32)
    labels = rng.integers(0, vocab, (b, seq)).astype(np.int32)
    labels[:, -3:] = -1                       # unsupervised tail
    batch = {"tokens": toks, "labels": labels}
    if weights:
        batch["weights"] = rng.uniform(0.5, 2.0, b).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["lm-tiny", "llama3.2-3b"])
def test_config_copy_equals_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))


@pytest.mark.parametrize("seq", [32, 320], ids=["naive", "online"])
def test_logits_match_reference(models, seq):
    """seq 32 takes ``attention_op``'s naive branch, seq 320 the
    ``online_attention`` one (q·k > 256²) on both sides: the port's forward
    runs with grad mode on, as training runs it (a forward-only call takes
    the flash route, below)."""
    jlm, params, lm = models
    batch = _batch(seq, seed=seq)
    want, _ = jlm.logits(params, _j(batch))
    got = lm(_t(batch)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("seq", [32, 320])
def test_forward_only_logits_take_the_flash_route(models, seq, monkeypatch):
    """The flash route is for CUDA tensors only (on the card, without grad
    mode and without explicit positions, every layer runs
    ``flash_attention`` with q_offset 0: the ``gpu`` case
    ``test_forward_only_route_is_chosen_on_cuda``). On the CPU the same
    forward keeps the chunked plain paths, whose memory stays bounded, and
    the logits match the reference."""
    from repro_torch.kernels.flash_attn import ops as k5_ops
    jlm, params, lm = models
    calls = []
    real = k5_ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw["q_offset"])
        return real(*a, **kw)
    monkeypatch.setattr(k5_ops, "flash_attention", spy)
    batch = _batch(seq, seed=seq)
    want, _ = jlm.logits(params, _j(batch))
    with torch.inference_mode():
        got = lm(_t(batch))
    assert calls == []
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    calls.clear()
    with torch.inference_mode():        # explicit positions: plain paths
        b = _t(batch)
        b["positions"] = torch.arange(seq)[None].expand(2, seq)
        lm(b)
    assert calls == []


@pytest.mark.parametrize("impl", ["naive", "chunked", "fused", "pallas"])
def test_token_stats_match_reference(impl):
    rng = np.random.default_rng(7)
    z = (rng.standard_normal((3, 17, 9000)) * 3).astype(np.float32)
    y = rng.integers(0, 9000, (3, 17)).astype(np.int32)
    ce_j, g2_j = jax_lm.token_stats(jnp.asarray(z), jnp.asarray(y), impl=impl)
    ce_p, g2_p = port_lm.token_stats(torch.from_numpy(z), torch.from_numpy(y),
                                     impl=impl)
    np.testing.assert_allclose(ce_p.numpy(), np.asarray(ce_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(g2_p.numpy(), np.asarray(g2_j), atol=ATOL,
                               rtol=0)


def test_token_stats_unported_impl_raises():
    """``"pallas"`` (K1) is forward only: under autograd it raises, as the
    reference's gradient through its Pallas call does; an unknown impl
    raises."""
    z = torch.zeros(2, 4, requires_grad=True)
    y = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        port_lm.token_stats(z, y, impl="pallas")
    with pytest.raises(ValueError, match="unknown score_impl"):
        port_lm.token_stats(z, y, impl="nope")


@pytest.mark.parametrize("weights", [False, True])
def test_loss_matches_reference(models, weights):
    jlm, params, lm = models
    batch = _batch(32, seed=3, weights=weights)
    want, _ = jlm.loss(params, _j(batch), remat=False)
    got, _ = lm.loss(_t(batch), remat=False)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("score_dtype", [None, "bfloat16"])
def test_sample_stats_match_reference(models, score_dtype):
    jlm, params, lm = models
    batch = _batch(32, b=4, seed=5)
    lj, sj = jlm.sample_stats(params, _j(batch), score_dtype=score_dtype)
    lp, sp = lm.sample_stats(_t(batch), score_dtype=score_dtype)
    # bf16 compute rounds at different places in the two frameworks
    tol = ATOL if score_dtype is None else 3e-2
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=tol, rtol=0)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), atol=tol,
                               rtol=tol)


def test_remat_changes_nothing(models):
    _, _, lm = models
    batch = _t(_batch(32, seed=9))
    grads = []
    for remat in (False, True):
        lm.zero_grad()
        loss, _ = lm.loss(batch, remat=remat)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in lm.named_parameters()})
    lm.zero_grad()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0, atol=0)
