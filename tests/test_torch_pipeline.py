"""The port's data plane against the reference's (``repro.data.pipeline``).

* ``MemmapLM``: indices and gathers bitwise the reference's on a corpus
  the test writes, with the size-1 permutation memo.
* The threaded depth-N ``DataPlane`` on the reference's own cases: depth
  N against sequential ``next_batch``, the plan cursor resuming, a gather
  error surfaced then recovered (a raising source, and ``faults``'
  ``gather@k``), the passthrough for impure schemes, the depth knob, the
  ``Prefetcher`` shim; ``plane.device_put_skipped`` for batches already
  on the plane's device, and the transfer counters.
* ``fit`` resumed across plane depths 1 → 3 bitwise the straight run
  (``presample`` kind and ``fused``), and ``fit`` at lm-tiny under
  ``prod`` with ``fused``, the ``presample`` kind and ``uniform`` at depths
  1, 2 and 3: plans bitwise across depths and bitwise JAX's, losses
  bitwise across depths and within ``LOSS_TOL`` of JAX's.

No wait here is unbounded: the plane's gets and joins take timeouts, and
every test checks that no thread it started outlives it.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import Experiment as JaxExperiment  # noqa: E402
from repro.api import Hook as JaxHook  # noqa: E402
from repro.api import build_run as jax_build_run  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.api import Experiment, Hook, build_run  # noqa: E402
from repro_torch.api.config import (apply_overrides, from_dict,  # noqa: E402
                                   to_dict)
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (DataConfig, FaultsConfig,  # noqa: E402
                                      ISConfig, ObsConfig, OptimConfig,
                                      RunConfig, SamplerConfig, ShapeConfig)
from repro_torch.data.pipeline import (DataPlane, MemmapLM,  # noqa: E402
                                       PipelineState, Prefetcher,
                                       SyntheticLM)
from repro_torch.runtime import faults  # noqa: E402
from repro_torch.sampler.schemes import make_sampler  # noqa: E402

LOSS_TOL = 1e-4
PROD = {"shape.seq_len": 16, "shape.global_batch": 4, "steps": 4,
        "obs.enabled": False, "imp.score_dtype": "float32"}


@pytest.fixture(autouse=True)
def no_thread_outlives():
    """Every thread a test starts is gone when it ends, and the count of
    threads is back where it was (a bounded wait: the plane's ``stop``
    has joined its workers already)."""
    before = set(threading.enumerate())
    yield
    faults.configure(None)
    deadline = time.monotonic() + 5.0
    while (set(threading.enumerate()) - before
           and time.monotonic() < deadline):
        time.sleep(0.05)
    left = [t.name for t in set(threading.enumerate()) - before]
    assert not left, left
    assert threading.active_count() <= len(before)


def _run_cfg(scheme, **kw):
    return RunConfig(
        model=get_config("lm-tiny"),
        shape=ShapeConfig("t", seq_len=16, global_batch=8, kind="train"),
        optim=OptimConfig(name="adamw", lr=1e-3),
        imp=ISConfig(enabled=True, presample_ratio=2, tau_th=1.2),
        sampler=SamplerConfig(scheme=scheme, min_coverage=0.25,
                              tau_th=1.001, temperature=0.5),
        remat=False, **kw)


def _uniform_sampler(n=64, seed=7):
    run = _run_cfg("uniform")
    src = SyntheticLM(run.model.vocab_size, 16, n_examples=n, seed=seed)
    return make_sampler(run, src, device=torch.device("cpu"))


# ---------------------------------------------------------------------------
# MemmapLM
# ---------------------------------------------------------------------------
def test_memmap_lm_matches_reference(tmp_path):
    path = tmp_path / "corpus.npy"
    corpus = np.random.default_rng(0).integers(0, 500, 4001).astype(np.int32)
    np.save(path, corpus)
    port = MemmapLM(path, seq_len=16, seed=3)
    ref = jpipe.MemmapLM(str(path), seq_len=16, seed=3, host_id=0,
                         n_hosts=1)
    assert port.n == ref.n == 250
    states = [PipelineState(0, 0), PipelineState(0, 240),
              PipelineState(1, 7), PipelineState(2, 249)]
    for st in states:
        ids = port.global_indices(st, 12)
        want = ref.global_indices(jpipe.PipelineState(st.epoch, st.cursor),
                                  12)
        assert ids.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(ids, want)
        got, exp = port.gather(ids, epoch=st.epoch), ref.gather(want)
        for k in ("tokens", "labels"):
            assert got[k].dtype == exp[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], exp[k])
        # rows are corpus slices: the labels are the tokens shifted by one
        o = int(ids[0]) * 16
        np.testing.assert_array_equal(got["tokens"][0], corpus[o:o + 16])
        np.testing.assert_array_equal(got["labels"][0], corpus[o + 1:o + 17])
    # the size-1 memo: one permutation per epoch, recomputed on a change
    p0 = port._perm(5)
    assert port._perm(5) is p0
    port._perm(6)
    assert port._perm(5) is not p0
    np.testing.assert_array_equal(port._perm(5), p0)
    batch, nxt = port.batch(PipelineState(0, 248), 4)
    assert nxt == PipelineState(1, 0)
    np.testing.assert_array_equal(batch["tokens"], ref.batch(
        jpipe.PipelineState(0, 248), 4)[0]["tokens"])


# ---------------------------------------------------------------------------
# the DataPlane (tests/test_plan.py's DataPlane cases)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("depth", [1, 3])
def test_dataplane_matches_sequential_next_batch(depth):
    a, b = _uniform_sampler(), _uniform_sampler()
    plane = DataPlane(a, depth=depth, device_put=False)
    assert plane.pipelined and not plane.finalize
    plane.start(PipelineState(), 0)
    pstate = PipelineState()
    try:
        for step in range(12):
            got_b, got_p, got_st = plane.next()
            want_b, want_p, pstate = b.next_batch(pstate, step)
            assert got_p.signature() == want_p.signature()
            np.testing.assert_array_equal(got_b["tokens"], want_b["tokens"])
            assert got_st == pstate
    finally:
        plane.stop()


def test_many_planes_under_a_short_switch_interval():
    """Stress: eight depth-3 planes (24 workers, more than the cores) at a
    5 µs switch interval, popped from eight consumer threads; each pops
    its plans in order, bitwise the sequential ones, and its credits and
    gather count add up (a lost update would break either)."""
    import sys
    want = []
    ref, pstate = _uniform_sampler(), PipelineState()
    for step in range(30):
        b, p, pstate = ref.next_batch(pstate, step)
        want.append((p.signature(), b["tokens"].copy()))
    planes = [DataPlane(_uniform_sampler(), depth=3, sync_launch=True)
              for _ in range(8)]
    errors = []

    def consume(plane):
        try:
            for sig, tokens in want:
                batch, plan, _ = plane.next()
                assert plan.signature() == sig
                np.testing.assert_array_equal(batch["tokens"], tokens)
        except Exception as e:            # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(5e-6)
    try:
        for plane in planes:
            plane.start(PipelineState(), 0)
        consumers = [threading.Thread(target=consume, args=(pl,))
                     for pl in planes]
        for t in consumers:
            t.start()
        for t in consumers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in consumers)
    finally:
        sys.setswitchinterval(old)
        for plane in planes:
            plane.stop()
    assert not errors, errors
    for plane in planes:
        assert plane._pops == 30
        assert plane.state_dict()["step"] == 30
        # one gather started per plan, never more in flight than credits
        assert 30 < plane._gathers_started <= 30 + plane.depth


def test_dataplane_plan_cursor_checkpoint_resume():
    """The plane's durable state is the plan cursor: a new plane started
    from ``state_dict()`` continues the identical plan sequence."""
    plane = DataPlane(_uniform_sampler(), depth=2, device_put=False)
    with pytest.raises(RuntimeError, match="no plan cursor"):
        plane.state_dict()
    plane.start(PipelineState(), 0)
    for _ in range(5):
        plane.next()
    ck = plane.state_dict()
    plane.stop()
    assert ck["step"] == 5
    ref, pstate = _uniform_sampler(), PipelineState()
    for step in range(5):
        _, _, pstate = ref.next_batch(pstate, step)
    assert ck["pipeline"] == pstate.as_dict()

    resumed = DataPlane(_uniform_sampler(), depth=2, device_put=False)
    resumed.start(PipelineState.from_dict(ck["pipeline"]), ck["step"])
    try:
        got_b, got_p, _ = resumed.next()
    finally:
        resumed.stop()
    want_b, want_p, _ = ref.next_batch(pstate, 5)
    assert got_p.signature() == want_p.signature()
    np.testing.assert_array_equal(got_b["tokens"], want_b["tokens"])


def test_dataplane_surfaces_gather_error_then_recovers():
    sampler = _uniform_sampler()
    inner_gather = sampler.source.gather
    state = {"fail": False}

    def flaky(indices, epoch=0):
        if state["fail"]:
            state["fail"] = False
            raise OSError("transient read error")
        return inner_gather(indices, epoch=epoch)

    sampler.source.gather = flaky
    plane = DataPlane(sampler, depth=1, device_put=False, sync_launch=True)
    plane.start(PipelineState(), 0)
    try:
        plane.next()
        state["fail"] = True
        plane.next()                           # in-flight batch unaffected
        with pytest.raises(OSError, match="transient"):
            plane.next()
        assert plane.fatal is None             # transient: no fatal set
        batch, plan, _ = plane.next()          # background retry succeeded
    finally:
        plane.stop()
    assert plan.step == 2                      # the plan that failed
    want = _uniform_sampler().source.gather(plan.gids, epoch=plan.epoch)
    np.testing.assert_array_equal(batch["tokens"], want["tokens"])


@pytest.mark.parametrize("depth", [1, 3])
def test_injected_gather_fault_is_surfaced_once_then_retried(depth):
    """``gather@2``: the step-2 plan's gather fails once on the worker;
    the consumer sees the error in order, then the same plan's batch —
    the same sequence as the reference's plane under the same schedule."""
    cfg = FaultsConfig(enabled=True, spec="gather@2")
    seqs = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            faults.configure(cfg)
            plane = DataPlane(_uniform_sampler(), depth=depth)
        else:
            from repro.configs.base import FaultsConfig as JaxFaultsConfig
            from repro.runtime import faults as jfaults
            from repro.sampler import make_sampler as jmake
            jfaults.configure(JaxFaultsConfig(enabled=True, spec="gather@2"))
            run = jax_build_run("lm-tiny", preset="smoke", overrides={
                "sampler.scheme": "uniform", "shape.seq_len": 16,
                "shape.global_batch": 8})
            plane = jpipe.DataPlane(jmake(run, jpipe.SyntheticLM(
                run.model.vocab_size, 16, n_examples=64, seed=7, host_id=0,
                n_hosts=1)), depth=depth, device_put=False)
        plane.start(PipelineState() if pkg == "port"
                    else jpipe.PipelineState(), 0)
        seq = []
        try:
            while len(seq) < 6:
                try:
                    _, plan, _ = plane.next()
                    seq.append(("ok", plan.step, plan.gids.tolist()))
                except Exception as e:          # noqa: BLE001
                    seq.append(("err", type(e).__name__))
        finally:
            plane.stop()
            if pkg == "jax":
                jfaults.configure(None)
        seqs.append(seq)
    assert [s[:2] for s in seqs[0]] == [
        ("ok", 0), ("ok", 1), ("err", "FaultInjected"), ("ok", 2), ("ok", 3),
        ("ok", 4)]
    assert seqs[0] == seqs[1]


def test_dataplane_not_pipelined_for_impure_schemes():
    run = _run_cfg("history")
    src = SyntheticLM(run.model.vocab_size, 16, n_examples=64, seed=7)
    sampler = make_sampler(run, src, device=torch.device("cpu"))
    plane = DataPlane(sampler, depth=4)
    assert not plane.pipelined
    # passthrough: begin/finish delegate to the sampler's two-phase API
    handle = plane.begin(PipelineState(), 0)
    batch, plan, _ = plane.finish(handle)
    assert plan.n_rows == run.shape.global_batch
    plane.stop()


def test_plane_plan_error_is_fatal():
    sampler = _uniform_sampler()

    def broken(pstate, step):
        raise ValueError("plan bug")

    sampler.plan = broken
    plane = DataPlane(sampler, depth=2)
    plane.start(PipelineState(), 0)
    try:
        with pytest.raises(ValueError, match="plan bug"):
            plane.next()
        assert isinstance(plane.fatal, ValueError)
        with pytest.raises(ValueError, match="plan bug"):
            plane.next()                       # no blocking on a dead worker
    finally:
        plane.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        plane._pop()


def test_prefetch_depth_is_a_config_knob():
    run = _run_cfg("uniform")
    assert run.data == DataConfig()
    assert (run.data.prefetch_depth, run.data.device_put) == (2, True)
    run2 = apply_overrides(run, {"data.prefetch_depth": "5",
                                 "data.device_put": "false"})
    assert run2.data.prefetch_depth == 5 and run2.data.device_put is False
    assert from_dict(to_dict(run2)) == run2          # lossless round-trip
    exp = Experiment(apply_overrides(run, {"data.prefetch_depth": 3}),
                     device="cpu")
    plane = exp.make_plane()
    assert (plane.depth, plane._device_put) == (3, True)
    assert plane.device == torch.device("cpu")


def test_prefetcher_is_deprecated_shim_over_depth1_plane():
    src = SyntheticLM(128, 16, n_examples=64, seed=7)
    with pytest.warns(DeprecationWarning, match="DataPlane"):
        pf = Prefetcher(src, PipelineState(), 8)
    try:
        assert isinstance(pf._plane, DataPlane)
        assert pf._plane.depth == 1
        got, st = pf.next()
    finally:
        pf._plane.stop()
    want, want_st = src.batch(PipelineState(), 8)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert st == want_st


# ---------------------------------------------------------------------------
# the device-put stage and the transfer counters
# (tests/test_fused_presample.py's plane cases)
# ---------------------------------------------------------------------------
def test_dataplane_skips_device_put_for_device_batches():
    """An already-device batch passes the device-put stage untouched and
    is counted in ``plane.device_put_skipped``; host batches are moved
    and charged by size. On the CPU the plane's device is the CPU: a
    tensor there is a device batch, a numpy array a host one."""
    obs.configure(ObsConfig(enabled=True))
    obs.reset()
    try:
        sampler = _uniform_sampler()
        host_gather = sampler.assembler.assemble
        sampler.assembler.assemble = (
            lambda plan, **kw: {k: torch.as_tensor(v) for k, v in
                                host_gather(plan, **kw).items()})
        plane = DataPlane(sampler, depth=2, device_put=True,
                          device=torch.device("cpu"))
        plane.start(PipelineState(), 0)
        try:
            for _ in range(4):
                batch, _, _ = plane.next()
                assert all(isinstance(v, torch.Tensor)
                           for v in batch.values())
        finally:
            plane.stop()
        snap = obs.snapshot()
        # >= consumed: the depth-2 plane legitimately pre-transfers ahead
        skipped = snap["plane.device_put_skipped"]
        assert skipped >= 4
        assert snap.get("plane.device_put_bytes", 0) == 0

        plane2 = DataPlane(_uniform_sampler(), depth=2, device_put=True,
                           device=torch.device("cpu"))
        plane2.start(PipelineState(), 0)
        try:
            batch, _, _ = plane2.next()
        finally:
            plane2.stop()
        assert all(isinstance(v, torch.Tensor) for v in batch.values())
        snap = obs.snapshot()
        assert snap["plane.device_put_bytes"] >= 2 * 8 * 16 * 4
        assert snap["plane.device_put_skipped"] == skipped   # unchanged
        for name in ("plane.plan", "plane.gather", "plane.device_put",
                     "plane.next_wait"):
            assert snap[name]["count"] > 0, name
        assert snap["plane.batches"] >= 5
    finally:
        obs.configure(ObsConfig())


def test_fused_transfer_counters_shrink_vs_host(tmp_path):
    """Per accepted step the fused path moves no train-path batch to the
    device (``loop.h2d_bytes`` 0: rows are gathered on the device) while
    the host path uploads its selected batch every step; both pull the
    same (B,) score vector back."""
    def counters(extra):
        ov = {"steps": 4, "imp.tau_th": 1.0001, "obs.enabled": "true",
              "obs.dir": str(tmp_path), "shape.seq_len": 16, **extra}
        exp = Experiment(build_run("lm-tiny", preset="smoke", overrides=ov),
                         device="cpu")
        obs.reset()
        exp.fit()
        snap = obs.snapshot()
        obs.configure(ObsConfig())
        return snap

    host = counters({"sampler.host_score": "true"})
    fused = counters({"imp.presample_impl": "fused"})
    assert host["loop.h2d_bytes"] > 0
    assert fused.get("loop.h2d_bytes", 0) == 0
    assert fused["engine.row_gathers"] == 4
    assert fused["sampler.d2h_bytes"] == host["sampler.d2h_bytes"] > 0
    # the fused pools went through the plane's workers
    assert fused["plane.batches"] >= 4
    assert fused["plane.device_put_skipped"] >= 4   # finalized device rows


# ---------------------------------------------------------------------------
# fit through the plane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["presample", "fused"])
def test_fit_resume_bitwise_across_plane_depths(scheme, tmp_path):
    """The plan cursor is the plane's only durable state: a run
    checkpointed at depth 1 resumes at depth 3 and reproduces the straight
    depth-3 run's losses and params bitwise."""
    def mk(ckpt, depth):
        imp = ISConfig(enabled=True, presample_ratio=2, tau_th=1.0001,
                       presample_impl="fused" if scheme == "fused" else "auto")
        run = dataclasses.replace(
            _run_cfg("presample"), imp=imp, ckpt_dir=str(ckpt), ckpt_every=4,
            data=DataConfig(prefetch_depth=depth))
        src = SyntheticLM(run.model.vocab_size, 16, n_examples=64, seed=9)
        return Experiment(run, source=src, device="cpu")

    sa, ha = mk(tmp_path / "a", 3).fit(steps=6)
    mk(tmp_path / "b", 1).fit(steps=3)            # interrupted at depth 1
    sb, hb = mk(tmp_path / "b", 3).fit(steps=6)   # resumed at depth 3
    assert len(hb) == 3
    assert [h["loss"] for h in ha][3:] == [h["loss"] for h in hb]
    for name, p in sa["params"].items():
        assert torch.equal(p, sb["params"][name]), name


def test_fused_gather_fault_propagates_as_in_the_reference():
    """A finalize plane pops its pool in ``begin``, outside the loop's
    re-pop (the reference's loop does the same): ``gather@1`` on ``prod``'s
    fused path leaves ``fit`` with the error and the plane's threads
    stopped."""
    run = build_run("lm-tiny", preset="prod", overrides=dict(PROD, **{
        "runtime.faults.enabled": True,
        "runtime.faults.spec": "gather@1"}))
    with pytest.raises(faults.FaultInjected, match="gather fault at step 1"):
        Experiment(run, device="cpu").fit()


def _recorder(base):
    class Plans(base):
        def __init__(self):
            self.sigs, self.gids = [], []

        def on_step_start(self, loop, step, batch, meta):
            self.sigs.append(meta.signature())
            self.gids.append(np.array(meta.gids))
    return Plans()


SCHEMES = {"fused": {}, "presample": {"imp.presample_impl": "step"},
           "uniform": {"sampler.scheme": "uniform"}}


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_fit_matches_reference_across_depths(scheme):
    """``prod`` at lm-tiny from the same initial params: the port's plans
    at depths 1, 2 and 3 are bitwise one another and JAX's (its default
    depth 2), the losses bitwise across depths and within ``LOSS_TOL`` of
    JAX's."""
    overrides = dict(PROD, **SCHEMES[scheme])
    jrun = jax_build_run("lm-tiny", preset="prod", overrides=overrides)
    jrec = _recorder(JaxHook)
    _, jhist = JaxExperiment(jrun).fit(hooks=[jrec])
    flat, _ = _flatten(JaxLM(jrun.model).init(jax.random.PRNGKey(jrun.seed)))
    flat = {k: np.asarray(v) for k, v in flat.items()}
    runs = []
    for depth in (1, 2, 3):
        run = build_run("lm-tiny", preset="prod", overrides=dict(
            overrides, **{"data.prefetch_depth": depth}))
        assert run.data.device_put
        exp = Experiment(run, device="cpu")
        assert exp.make_plane().pipelined
        interop.load_params(exp.lm, flat)
        rec = _recorder(Hook)
        _, hist = exp.fit(hooks=[rec])
        runs.append((rec, hist))
    for rec, hist in runs:
        assert rec.sigs == runs[0][0].sigs
        assert [h["loss"] for h in hist] == [h["loss"]
                                             for h in runs[0][1]]
    rec, hist = runs[0]
    assert len(hist) == len(jhist) == 4
    assert rec.sigs == jrec.sigs
    for m, jm in zip(hist, jhist):
        np.testing.assert_allclose(m["loss"], jm["loss"], atol=LOSS_TOL,
                                   rtol=0)


def test_fused_plans_bitwise_across_depths_with_is_active():
    """With the gate lowered so the fused path's race picks weighted
    winners, the plan stream (gids, probs, HT weights, τ flag) is bitwise
    the same at every depth."""
    sigs = []
    for depth in (1, 2, 3):
        run = build_run("lm-tiny", preset="prod", overrides=dict(PROD, **{
            "imp.tau_th": 1.01, "data.prefetch_depth": depth}))
        rec = _recorder(Hook)
        _, hist = Experiment(run, device="cpu").fit(hooks=[rec])
        sigs.append((rec.sigs, [h["loss"] for h in hist]))
        assert any(h["sampler_active"] for h in hist), "IS never active"
    assert sigs[0] == sigs[1] == sigs[2]
