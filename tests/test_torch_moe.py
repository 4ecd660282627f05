"""The MoE FFN (``repro_torch.models.moe``) and granite-moe-3b-a800m
against the JAX package, at reduced granite (4 of 48 experts routed, top
2, d_expert 64; f32 unless a case says otherwise), with the same
parameters through the checkpoint format and the same seeded numpy inputs:

* ``MoE`` against ``apply_moe``: the output to 2e-6 of its largest
  |value| (and to 1e-6 of it against the same math in float64), the aux
  to 1e-6, over 1200 tokens
  (two dispatch groups) with the router scaled so that capacity drops
  happen (the drop count > 0 and the reference's), with a shared expert,
  and with an exact three-way router tie that goes to the lower experts;
* the model: logits, the loss with its aux, and every gradient (the padded
  experts' zero ones included; the port through ``remat``);
* one ``prod`` step: plans bitwise, the loss to 1e-4, as
  ``tests/test_torch_archs.py`` holds gemma3;
* the padded experts' weight decay after that step, as the reference's;
* the train state (params and AdamW's master, m and v, each expert leaf
  stacked to (repeats, 48, d, f)) through a checkpoint both ways (and
  musicgen's and llava's), and in bf16 (the router stays f32) from the
  reference into the port;
* serve: a prefill, then 3 decode steps.
"""
import copy
import dataclasses
import functools

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
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import OptimConfig as JOptimConfig  # noqa: E402
from repro.core.is_train import train_state_init as jax_state  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.optim import api as jax_optim  # noqa: E402
from repro_torch.api import Experiment, Hook, build_run  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.checkpoint.ckpt import Checkpointer  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import OptimConfig  # noqa: E402
from repro_torch.core.is_train import train_state_init  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.optim import api as optim  # noqa: E402

ARCH = "granite-moe-3b-a800m"
MOE_TOL = 1e-6
ATOL = 1e-5
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(repeats=1, **moe_kw):
    jcfg = jax_reduced(jax_get_config(ARCH), repeats=repeats)
    cfg = reduced(get_config(ARCH), repeats=repeats)
    if moe_kw:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _np(tree):
    flat, _ = _flatten(tree)
    return {k: np.asarray(v) for k, v in flat.items()}


# the reference's functions under one jit each: its eager dispatch compiles
# every primitive at every new shape, several seconds a call here
_init_moe = jax.jit(jmoe.init_moe, static_argnums=1)
_apply_moe = jax.jit(jmoe.apply_moe, static_argnums=2)


@functools.lru_cache(maxsize=None)
def _jit_init(jcfg):
    return jax.jit(JaxLM(jcfg).init)


def _init(jcfg, seed):
    return _jit_init(jcfg)(jax.random.PRNGKey(seed))


def _moe_pair(jcfg, cfg, router=None, seed=0):
    """The reference's ``init_moe`` params (``router`` replaces its router)
    and a port ``MoE`` holding them."""
    jp = _init_moe(jax.random.PRNGKey(seed), jcfg)
    if router is not None:
        jp["router"] = jnp.asarray(router)
    mod = moe.MoE(cfg, "cpu", torch.Generator().manual_seed(0))
    flat = _np(jp)
    assert {n.replace(".", "/") for n, _ in mod.named_parameters()} \
        == set(flat)
    with torch.no_grad():
        for n, p in mod.named_parameters():
            p.copy_(torch.from_numpy(flat[n.replace(".", "/")].copy()))
    return jp, mod


def _jax_routing(jp, x, jcfg):
    """The reference's routing steps of ``apply_moe`` at one host: the
    expert choices and the number of (token, choice) pairs dropped."""
    t = x.shape[0] * x.shape[1]
    g = max(t // jmoe.GROUP_TOKENS, 1)
    while t % g:
        g -= 1
    idx, pos = _routing(jp["router"], jnp.asarray(x), jcfg, g)
    return np.asarray(idx), int((pos >= jmoe._capacity(t // g, jcfg.moe))
                                .sum()), g


@functools.partial(jax.jit, static_argnums=(2, 3))
def _routing(router, x, jcfg, g):
    m = jcfg.moe
    tg = x.shape[0] * x.shape[1] // g
    logits = jnp.einsum("gtd,de->gte",
                        x.reshape(g, tg, -1).astype(jnp.float32), router)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    onehot = jax.nn.one_hot(idx, m.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(g, tg * m.top_k, m.n_experts)
    pos = ((jnp.cumsum(flat, axis=1) - flat)
           .reshape(g, tg, m.top_k, m.n_experts) * onehot).sum(-1)
    return idx, pos


def _check_moe(jp, mod, jcfg, x):
    """The output and aux against ``apply_moe``'s; returns the reference's
    routing. The output's sums run over three products in an f32 order
    that differs between BLAS and XLA, and the reference's own output lies
    up to 1.4e-6 of its largest |value| from the same math in float64
    (6.5e-6 at 4.55 in the drops case): so the port is held to
    ``MOE_TOL`` of that scale against its own float64 evaluation (the
    routing is the same) and to twice that against the reference."""
    want, jaux = _apply_moe(jp, jnp.asarray(x), jcfg)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    with torch.no_grad():
        got, aux = mod(torch.from_numpy(x))
        exact, _ = copy.deepcopy(mod).double()(torch.from_numpy(x).double())
    np.testing.assert_allclose(got.numpy(), exact.numpy(),
                               atol=MOE_TOL * scale, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=2 * MOE_TOL * scale,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=MOE_TOL, rtol=0)
    return _jax_routing(jp, x, jcfg)


def _drops(mod, x):
    """The (token, choice) pairs the port's routing of x drops."""
    with torch.no_grad():
        return int((~mod.route(torch.from_numpy(x))["keep"]).sum())


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_matches_reference_with_capacity_drops(shared):
    jcfg, cfg = _cfgs(n_shared_experts=shared)
    rng = np.random.default_rng(3 + shared)
    d = cfg.d_model
    # the tokens share a direction that expert 0's router column follows:
    # most tokens choose expert 0, more than its capacity takes
    mu = rng.normal(size=d)
    router = rng.normal(size=(d, cfg.moe.n_experts))
    router[:, 0] += 0.5 * mu
    jp, mod = _moe_pair(jcfg, cfg, router=router.astype(np.float32),
                        seed=shared)
    assert (mod.shared is None) == (not shared)
    x = (rng.normal(size=(2, 600, d)) + 0.5 * mu).astype(np.float32)
    _, drops, g = _check_moe(jp, mod, jcfg, x)
    assert g == 2 and moe._groups(1200) == 2
    assert drops > 0
    assert _drops(mod, x) == drops


def test_moe_router_tie_goes_to_the_lower_experts():
    """Experts 1, 2 and 3 share one router column, above expert 0's: every
    token's top 2 are experts 1 and 2 (``lax.top_k``'s order), and the
    output and aux equal the reference's."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(11)
    d = cfg.d_model
    col = rng.normal(size=d).astype(np.float32)
    router = np.stack([col * 0.5, col, col, col], axis=1)
    jp, mod = _moe_pair(jcfg, cfg, router=router)
    x = np.abs(rng.normal(size=(2, 24, d))).astype(np.float32) * \
        np.sign(col)[None, None]                  # x·col > 0 for every token
    idx, drops, _ = _check_moe(jp, mod, jcfg, x)
    assert (idx == [1, 2]).all()
    probs = torch.softmax(torch.from_numpy(x).reshape(1, -1, d)
                          @ torch.from_numpy(router), -1)
    assert (probs[..., 1] == probs[..., 3]).all()
    _, mine = moe.top_k(probs, 2)
    assert (mine.numpy() == [1, 2]).all()
    assert drops == _drops(mod, x) > 0


@pytest.fixture(scope="module")
def granite():
    """Reduced granite at ``repeats=2``: the reference's params from the
    ``prod`` preset's seed (0), which its ``prod`` step initialises from
    too, and a port ``LM`` holding them."""
    jcfg, cfg = _cfgs(repeats=2)
    params = _init(jcfg, 0)
    lm = interop.params_from_numpy(_np(params), cfg, "cpu")
    return JaxLM(jcfg), params, lm


def _batch(vocab, b=2, s=40, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    return {"tokens": toks, "labels": labels.astype(np.int32)}


def test_granite_logits_loss_aux_and_grads_match_reference(granite):
    jlm, params, lm = granite
    batch = _batch(lm.cfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, jaux = jax.jit(jlm.logits)(params, jb)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, jb, remat=False), has_aux=True))(params)
    with torch.no_grad():
        got, aux = lm.logits(tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), atol=MOE_TOL, rtol=0)
    lm.zero_grad(set_to_none=True)
    loss, m = lm.loss(tb, remat=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(m["aux"].detach()), float(jm["aux"]),
                               atol=MOE_TOL, rtol=0)
    np.testing.assert_allclose(float(m["ce"].detach() + m["aux"].detach()),
                               float(loss.detach()), rtol=1e-6)
    flat = _np(jgrads)
    named = dict(lm.named_parameters())
    assert {interop.jax_key(n) for n in named} == set(flat)
    for name, p in named.items():
        key, layer = interop._split(name)
        w = flat[key] if layer is None else flat[key][layer]
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), w, atol=ATOL, rtol=0,
                                   err_msg=name)
        if key.endswith("experts/w_up"):
            assert not p.grad[4:].any() and p.grad[:4].any()
    lm.zero_grad(set_to_none=True)


def _recorder(base):
    class Plans(base):
        def __init__(self):
            self.plans = []

        def on_step_start(self, loop, step, batch, meta):
            self.plans.append((np.array(meta.gids), None if meta.weights
                               is None else np.array(meta.weights)))
    return Plans()


def test_granite_prod_step_matches_reference(granite):
    """One ``prod`` step (fused, survival-pruned presample; the gate lowered
    so importance sampling is on): the plan's gids bitwise, its weights to
    float32 rounding, the loss (with the aux) to 1e-4."""
    overrides = {"shape.seq_len": 32, "shape.global_batch": 4, "steps": 1,
                 "obs.enabled": False, "imp.score_dtype": "float32",
                 "imp.tau_th": 1.01}
    jcfg, cfg = _cfgs(repeats=2)
    jrun = jax_build_run(preset="prod", overrides=overrides, model=jcfg)
    prun = build_run(preset="prod", overrides=overrides, model=cfg)
    jrec, prec = _recorder(JaxHook), _recorder(Hook)
    jstate, jhist = JaxExperiment(jrun).fit(hooks=[jrec])
    # the reference's run starts from init(PRNGKey(seed)): the fixture's
    assert jrun.seed == 0 and jrun.model == granite[0].cfg
    flat = _np(granite[1])
    exp = Experiment(prun, device="cpu")
    interop.load_params(exp.lm, flat)
    _, hist = exp.fit(hooks=[prec])
    assert len(hist) == len(jhist) == 1
    (g, w), (jg, jw) = prec.plans[0], jrec.plans[0]
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_allclose(w, jw, rtol=1e-6, atol=0)
    np.testing.assert_allclose(hist[0]["loss"], jhist[0]["loss"],
                               atol=LOSS_TOL, rtol=0)
    # the padded experts, never routed to, get zero gradients, which AdamW
    # turns into weight decay alone: as the reference's
    key = "segments/seg0/stacked/p0/ffn/experts/w_up"
    got = interop.params_to_numpy(exp.lm)[key][:, 4:]
    want = np.asarray(_np(jstate["params"])[key])[:, 4:]
    assert np.abs(got - flat[key][:, 4:]).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _jax_train_state(jcfg, seed):
    """The reference's AdamW train state with m and v drawn from a seed."""
    jlm = JaxLM(jcfg)
    opt = jax_optim.get_optimizer(JOptimConfig(name="adamw"))
    state = jax_state(jlm, opt, jax.random.PRNGKey(seed),
                      params=_init(jcfg, seed))
    rng = np.random.default_rng(seed)
    fill = lambda a: jnp.asarray(
        np.abs(rng.normal(size=a.shape)).astype(np.float32))
    state["opt"] = dict(state["opt"],
                        m=jax.tree_util.tree_map(fill, state["opt"]["m"]),
                        v=jax.tree_util.tree_map(fill, state["opt"]["v"]))
    return state


def _port_state(cfg):
    lm = LM(cfg, "cpu")
    return lm, train_state_init(lm, optim.get_optimizer(
        OptimConfig(name="adamw")))


def _payload_np(payload):
    """``params/<key>`` and ``opt/<part>/<key>`` of a port train payload as
    numpy, per-layer tensors stacked on the leading axis."""
    def host(v):
        if isinstance(v, list):
            return np.stack([t.detach().numpy() for t in v])
        return v.detach().numpy()
    out = {f"params/{k}": host(v) for k, v in payload["params"].items()}
    for part, leaves in payload["opt"].items():
        out.update({f"opt/{part}/{k}": host(v) for k, v in leaves.items()})
    return out


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("arch", [ARCH, "musicgen-medium",
                                  "llava-next-34b"])
def test_train_state_crosses_both_ways(arch, tmp_path):
    """The reference's train state of the reduced arch restores into the
    port (``interop.load_train_state``) and the port's back into the
    reference's tree: params and opt/{master,m,v} bitwise; granite's
    expert leaves stacked (repeats, 48, d, f), its router (d, 4);
    musicgen's without ``embed``."""
    jcfg = jax_reduced(jax_get_config(arch), repeats=2)
    cfg = reduced(get_config(arch), repeats=2)
    jstate = _jax_train_state(jcfg, 5)
    want = _np({"params": jstate["params"], "opt": jstate["opt"]})
    if arch == ARCH:
        assert want[
            "params/segments/seg0/stacked/p0/ffn/experts/w_gate"].shape \
            == (2, 48, cfg.d_model, 64)
        assert want["params/segments/seg0/stacked/p0/ffn/router"].shape \
            == (2, cfg.d_model, 4)
    assert ("opt/m/embed" in want) == (arch != "musicgen-medium")
    JaxCheckpointer(tmp_path / "j").save(1, {"train": jstate})
    lm, state = _port_state(cfg)
    state, step = interop.load_train_state(Checkpointer(tmp_path / "j"),
                                           state, seed=0)
    assert step == 1
    got = interop.train_payload(state)
    _same(_payload_np(got), want)

    Checkpointer(tmp_path / "p").save(2, {"train": got})
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    back, step = JaxCheckpointer(tmp_path / "p").restore({"train": zeros})
    assert step == 2
    _same(_np({"params": back["train"]["params"],
               "opt": back["train"]["opt"]}), want)


def test_granite_bf16_params_cross_with_an_f32_router(tmp_path):
    """In a bf16 model the router stays f32: the reference's checkpoint of
    bf16 granite restores into the port bit for bit, router f32, experts
    bf16; the port's own checkpoint restores into a fresh port model."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in _cfgs(repeats=2))
    params = _init(jcfg, 6)
    JaxCheckpointer(tmp_path / "j").save(1, {"params": params})
    lm = LM(cfg, "cpu")
    layer = lm.segments["seg0"].stacked["p0"][1].ffn
    assert layer.router.dtype == torch.float32
    assert layer.experts.w_gate.dtype == torch.bfloat16
    Checkpointer(tmp_path / "j").restore(
        {"params": interop.stacked(dict(lm.named_parameters()))})
    want = _np(params)
    _same(interop.params_to_numpy(lm), {k: v.astype(np.float32)
                                        for k, v in want.items()})
    assert layer.router.dtype == torch.float32
    Checkpointer(tmp_path / "p").save(
        2, {"params": interop.stacked(dict(lm.named_parameters()))})
    lm2 = LM(cfg, "cpu")
    Checkpointer(tmp_path / "p").restore(
        {"params": interop.stacked(dict(lm2.named_parameters()))})
    for (n, a), (_, b2) in zip(lm.named_parameters(), lm2.named_parameters()):
        assert a.dtype == b2.dtype and torch.equal(a, b2), n


def test_granite_serve_matches_reference(granite):
    """A prefill of 12 tokens, then 3 teacher-forced decode steps (each a
    batch of 2 tokens through the MoE): the last-position logits of each
    to 1e-5, through explicit positions and through ``q_offset``."""
    jlm, params, lm = granite
    cfg = lm.cfg
    rng = np.random.default_rng(2)
    B, P, GEN, CAP = 2, 12, 3, 20
    toks = rng.integers(0, cfg.vocab_size, (B, P + GEN)).astype(np.int32)
    jc, pc, qc = jlm.caches(B, CAP), lm.caches(B, CAP), lm.caches(B, CAP)
    steps = [(toks[:, :P], 0)] + [(toks[:, P + i:P + i + 1], P + i)
                                  for i in range(GEN)]
    jstep = jax.jit(jlm.serve_step)
    with torch.inference_mode():
        for t, off in steps:
            pos = np.broadcast_to(np.arange(off, off + t.shape[1],
                                            dtype=np.int32)[None], t.shape)
            want, jc = jstep(params, jc, {
                "tokens": jnp.asarray(t), "positions": jnp.asarray(pos)})
            got, pc = lm.serve_step(pc, {
                "tokens": torch.from_numpy(t),
                "positions": torch.from_numpy(np.ascontiguousarray(pos))})
            got2, qc = lm.serve_step(qc, {"tokens": torch.from_numpy(t)},
                                     q_offset=off)
            for g in (got, got2):
                np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                           atol=ATOL, rtol=0)
