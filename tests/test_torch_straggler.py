"""The straggler monitor, the fault schedule and the loop's retry, against
the reference (``repro.runtime``, ``repro.api.loop``).

* ``StragglerMonitor``: the action and gauge sequences of a seeded list
  of step times equal the reference's, every rung included.
* ``faults``: ``parse_spec`` (and its errors) and the firing sequence
  equal the reference's.
* The loop: events in order, the scripted ``SkipOnce`` retry (attempts
  ``[1, 2, 1, 1]``, ``dt_total`` > ``dt``), the globally reduced vote,
  the same batch retried, hook errors isolated and counted while votes
  are not (tests/test_api_loop.py, tests/test_runtime.py and
  tests/test_obs.py's cases).
* The restore: a retried run's final params, optimizer state, generator
  state and losses are bitwise a clean run's (``fused`` and the
  ``presample`` kind with its draws), its events and losses equal JAX's
  under the same scripted monitor; a run whose real monitor never arms
  takes no copy of the state, and a ``slow@`` schedule that arms it
  retries one step and restores it; the monitor's escalation leaves
  ``fit`` with a ``MembershipChange`` and no worker thread left.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.api import Experiment as JaxExperiment  # noqa: E402
from repro.api import Hook as JaxHook  # noqa: E402
from repro.api import build_run as jax_build_run  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs.base import FaultsConfig as JaxFaultsConfig  # noqa: E402
from repro.configs.base import ObsConfig as JaxObsConfig  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.runtime import faults as jfaults  # noqa: E402
from repro.runtime import straggler as jstraggler  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.api import Experiment, Hook, build_run  # noqa: E402
from repro_torch.api import loop as loop_mod  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.configs.base import FaultsConfig, ObsConfig  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.runtime import faults  # noqa: E402
from repro_torch.runtime.membership import MembershipChange  # noqa: E402
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: E402

LOSS_TOL = 1e-4
TINY = {"shape.seq_len": 16, "shape.global_batch": 4, "steps": 4,
        "obs.enabled": False, "imp.score_dtype": "float32"}
KINDS = {"fused": {}, "presample": {"imp.presample_impl": "step"}}


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


def _exp(extra=None, gate=None, steps=4):
    run = build_run("lm-tiny", preset="prod",
                    overrides=dict(TINY, steps=steps, **(extra or {})))
    return Experiment(run, device="cpu", gate=gate)


class SkipOnce:
    """A scripted monitor: a skip on its ``at``-th observation only."""

    def __init__(self, at=2):
        self.at, self.calls = at, 0

    def observe(self, dt):
        self.calls += 1
        return {"skip": self.calls == self.at, "b_scale": 1.0,
                "over_deadline": False}


def _events(base):
    class Recorder(base):
        def __init__(self):
            self.events, self.retries, self.loop = [], [], None

        def on_loop_start(self, loop, start, steps):
            self.loop = loop
            self.events.append(("loop_start", start, steps))

        def on_step_start(self, loop, step, batch, meta):
            self.events.append(("step_start", step))

        def on_retry(self, loop, step, attempt, dt):
            self.retries.append((step, attempt))
            self.events.append(("retry", step, attempt))

        def on_step_end(self, loop, step, metrics):
            self.events.append(("step_end", step))

        def on_scores_ready(self, loop, step, meta, scores):
            self.events.append(("scores_ready", step))

        def on_loop_end(self, loop, state, history):
            self.events.append(("loop_end", len(history)))
    return Recorder()


# ---------------------------------------------------------------------------
# the monitor and the fault schedule against the reference
# ---------------------------------------------------------------------------
def _dts():
    rng = np.random.default_rng(19)
    dts = list(rng.uniform(0.9, 1.1, 12))
    dts += [10.0] * 7                       # shrink, shrink, 3 skips, escalate
    dts += list(rng.uniform(0.9, 1.1, 30))  # recover
    dts += list(rng.choice([1.0, 2.5, 9.0], 40, p=[0.6, 0.2, 0.2]))
    return [float(x) for x in dts]


@pytest.mark.parametrize("kw", [{}, {"deadline_factor": 1.5, "max_skips": 1},
                                {"alpha": 0.95, "min_b_scale": 0.2,
                                 "max_skips": 2}])
def test_monitor_actions_and_gauges_equal_reference(kw):
    obs.configure(ObsConfig(enabled=True))
    jobs.configure(JaxObsConfig(enabled=True))
    obs.reset()
    jobs.reset()
    try:
        port, ref = StragglerMonitor(**kw), jstraggler.StragglerMonitor(**kw)
        rungs = set()
        for dt in _dts():
            assert port.deadline() == ref.deadline()
            a, b = port.observe(dt), ref.observe(dt)
            assert a == b, (dt, a, b)
            rungs.update(k for k in ("skip", "escalate") if a[k])
            ps, js = obs.snapshot(), jobs.snapshot()
            for name in ("straggler.ema_s", "straggler.deadline_s",
                         "straggler.b_scale", "straggler.skips"):
                assert ps.get(name) == js.get(name), name
        assert port.state == type(port.state)(**vars(ref.state))
        assert rungs == {"skip", "escalate"}
    finally:
        obs.configure(ObsConfig())
        jobs.configure(JaxObsConfig())


SPECS = ["", "gather@4", "timeout@3:1:2;slow@5:0:0.4", " die@8:1 ; ",
         "slow@2::0.3", "gather@x", "boom@3", "gather", "slow@1:0:abc"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_as_the_reference(spec):
    def parse(mod):
        try:
            return ("ok", mod.parse_spec(spec))
        except ValueError as e:
            return (type(e).__name__, str(e))
    assert parse(faults) == parse(jfaults)


def test_fault_firing_equals_reference():
    spec = "timeout@3:1:2;gather@4;slow@5:0:0.4;slow@5:1:0.9;gather@6:1"
    calls = [("set_step", 3), ("should", "timeout", None),
             ("should", "timeout", None), ("should", "timeout", None),
             ("raise_if", "gather", 4), ("raise_if", "gather", 4),
             ("slow", 5), ("slow", 5), ("set_step", 6),
             ("raise_if", "gather", None), ("should", "die", 8),
             ("slow", 7)]
    for host in (0, 1):
        seqs = []
        for mod, cfg in ((faults, FaultsConfig), (jfaults, JaxFaultsConfig)):
            mod.configure(cfg(enabled=True, spec=spec), host_id=host)
            out = []
            for c in calls:
                if c[0] == "set_step":
                    mod.set_step(c[1])
                elif c[0] == "should":
                    out.append(mod.should(c[1], step=c[2]))
                elif c[0] == "slow":
                    out.append(mod.slow_penalty(c[1]))
                else:
                    try:
                        mod.raise_if(c[1], op="plane", step=c[2])
                        out.append(None)
                    except RuntimeError as e:
                        out.append(str(e))
            assert mod.active()
            mod.configure(None)
            assert not mod.active()
            seqs.append(out)
        assert seqs[0] == seqs[1], host
    # disabled: every site is inert
    faults.configure(FaultsConfig(enabled=False, spec="gather@1"))
    assert not faults.active() and faults.slow_penalty(1) == 0.0
    faults.raise_if("gather", step=1)
    faults.die_if(1)


# ---------------------------------------------------------------------------
# the reference's monitor cases (tests/test_runtime.py)
# ---------------------------------------------------------------------------
def test_straggler_shrinks_presample_then_skips():
    mon = StragglerMonitor(deadline_factor=1.5, max_skips=1)
    for _ in range(10):
        mon.observe(1.0)
    a = mon.observe(10.0)                  # first breach: shrink B
    assert a["over_deadline"] and a["b_scale"] < 1.0 and not a["skip"]
    a = mon.observe(10.0)                  # second breach: B at min
    assert a["b_scale"] == pytest.approx(1 / 3, rel=0.4)
    a = mon.observe(10.0)                  # third breach: escalate to skip
    assert a["skip"]
    a = mon.observe(10.0)                  # skips exhausted: forced sync
    assert not a["skip"] and a["escalate"]


def test_straggler_recovers():
    mon = StragglerMonitor(deadline_factor=2.0)
    for _ in range(10):
        mon.observe(1.0)
    mon.observe(5.0)
    assert mon.state.b_scale < 1.0
    for _ in range(30):
        mon.observe(1.0)
    assert mon.state.b_scale == 1.0


def test_straggler_skip_retries_same_batch():
    """A skip RETRIES the same batch (bounded), so every requested
    optimizer step happens and no batch is dropped."""
    exp = _exp(KINDS["presample"], steps=6)
    seen = []
    orig_step = exp.step_fn

    def recording_step(state, *a):
        seen.append(a[0]["tokens"].clone())
        return orig_step(state, *a)

    exp.step_fn = recording_step
    exp.monitor = SkipOnce(at=3)
    state, hist = exp.fit(steps=6)
    assert len(seen) == 7                  # 6 accepted steps + 1 retry
    assert torch.equal(seen[2], seen[3])   # the skipped attempt, retried
    assert state["step"] == 6 and len(hist) == 6
    assert not torch.equal(seen[3], seen[4])


# ---------------------------------------------------------------------------
# the loop (tests/test_api_loop.py, tests/test_obs.py)
# ---------------------------------------------------------------------------
def test_events_fire_in_order():
    rec = _events(Hook)
    _, hist = _exp().fit(hooks=[rec])
    names = [e[0] for e in rec.events]
    assert rec.events[0] == ("loop_start", 0, 4)
    assert names.count("step_start") == names.count("step_end") == 4
    assert names.count("scores_ready") == 4
    assert "retry" not in names
    assert rec.events[-1] == ("loop_end", 4)
    i_start1 = rec.events.index(("step_start", 1))
    assert rec.events.index(("scores_ready", 0)) > i_start1


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_retry_event_and_monitor_swap_match_reference(kind):
    """A scripted monitor voting one skip: the loop emits ``retry`` and
    re-runs the same batch, as JAX's loop does under the same monitor
    (same events, attempts, losses to ``LOSS_TOL``)."""
    overrides = dict(TINY, **KINDS[kind])
    jrun = jax_build_run("lm-tiny", preset="prod", overrides=overrides)
    jexp = JaxExperiment(jrun)
    jexp.monitor = SkipOnce()
    jrec = _events(JaxHook)
    _, jhist = jexp.fit(steps=4, hooks=[jrec])

    exp = _exp(KINDS[kind])
    flat, _ = _flatten(JaxLM(jrun.model).init(jax.random.PRNGKey(jrun.seed)))
    interop.load_params(exp.lm, {k: np.asarray(v) for k, v in flat.items()})
    exp.monitor = SkipOnce()
    rec = _events(Hook)
    state, hist = exp.fit(steps=4, hooks=[rec])
    assert rec.retries == jrec.retries == [(1, 0)]
    assert rec.events == jrec.events
    assert state["step"] == 4 and len(hist) == 4
    assert [h["attempts"] for h in hist] == [h["attempts"] for h in jhist] \
        == [1, 2, 1, 1]
    for h in hist:
        if h["attempts"] == 1:
            assert h["dt_total"] == h["dt"]
        else:
            assert h["dt_total"] > h["dt"]
    for m, jm in zip(hist, jhist):
        np.testing.assert_allclose(m["loss"], jm["loss"], atol=LOSS_TOL,
                                   rtol=0)
    assert rec.loop.snapshot.taken == 5 and rec.loop.snapshot.restored == 1
    assert rec.loop.snapshot.where == "cpu"


def test_retry_vote_is_globally_reduced(monkeypatch):
    """The retry decision flows through ``collectives.allreduce_any``, so
    every host takes the same branch. Simulate the NON-straggler host of
    a two-host pod: no local hook votes, but the OR-reduce reports that
    another host did — this host retries too (and, at many hosts, arms
    the state copy on every attempt, since any host may vote)."""
    votes = []

    def fake_any(flag, *, n_hosts=1):
        assert n_hosts == 2
        votes.append(bool(flag))
        return len(votes) == 2      # "another host" voted on attempt 2

    monkeypatch.setattr(loop_mod.collectives, "allreduce_any", fake_any)
    exp = _exp(steps=3)
    exp.sampler.n_hosts = 2
    clean = _exp(steps=3)
    rec = _events(Hook)
    state, hist = exp.fit(steps=3, hooks=[rec])
    assert votes and not any(votes)
    assert rec.retries == [(1, 0)]
    assert [h["attempts"] for h in hist] == [1, 2, 1]
    assert rec.loop.snapshot.restored == 1
    monkeypatch.undo()
    cstate, chist = clean.fit(steps=3)
    assert [h["loss"] for h in hist] == [h["loss"] for h in chist]
    for name, p in state["params"].items():
        assert torch.equal(p, cstate["params"][name]), name


def test_allreduce_any_is_the_identity_at_one_host():
    assert collectives.allreduce_any(True) is True
    assert collectives.allreduce_any(False) is False
    with pytest.raises(NotImplementedError, match="not ported"):
        collectives.allreduce_any(True, n_hosts=2)


def test_a_vote_without_a_copy_of_the_state_raises():
    """``may_vote`` False is a promise; breaking it cannot silently apply
    an update twice."""
    class Liar(Hook):
        def may_vote(self, loop):
            return False

        def on_step_timed(self, loop, step, attempt, dt):
            return step == 1

    with pytest.raises(RuntimeError, match="no copy of the state"):
        _exp().fit(hooks=[Liar()])


def test_hook_exceptions_are_isolated(capsys):
    class Bomb(Hook):
        def on_step_end(self, loop, step, metrics):
            raise RuntimeError("boom")

    exp = _exp({"obs.enabled": True, "obs.sink": "none"})
    obs.reset()
    try:
        _, hist = exp.fit(hooks=[Bomb()])
        assert len(hist) == 4                  # the run survived
        assert obs.get_registry().counter("loop.hook_errors").value == 4
    finally:
        obs.configure(ObsConfig())
    err = capsys.readouterr().err
    assert err.count("Bomb.on_step_end raised RuntimeError") == 1  # once


def test_retry_votes_are_not_isolated():
    class BadVoter(Hook):
        def on_step_timed(self, loop, step, attempt, dt):
            raise RuntimeError("votes are control flow")

    with pytest.raises(RuntimeError, match="control flow"):
        _exp(steps=2).fit(steps=2, hooks=[BadVoter()])


# ---------------------------------------------------------------------------
# the restore
# ---------------------------------------------------------------------------
def _final(exp, state):
    opt = {f"{k}/{n}": t.clone() for k, d in state["opt"].items()
           for n, t in d.items()}
    return ({n: p.detach().clone() for n, p in state["params"].items()},
            opt, state["rng"].get_state(), state["ctrl"], state["step"])


@pytest.mark.parametrize("kind,gate", [("fused", None),
                                       ("presample", "always")])
def test_retried_run_is_bitwise_a_clean_run(kind, gate):
    """Two scripted skips (step 1 once, step 2 twice): every retried
    attempt starts from the state before the first, so the run ends where
    a clean run ends, bit for bit — params, AdamW's master, m and v, the
    draw generator (the ``presample`` kind draws with ``gate="always"``),
    the τ controller and the losses."""
    class Skips:
        def __init__(self):
            self.calls = 0

        def observe(self, dt):
            self.calls += 1
            return {"skip": self.calls in (2, 4, 5), "b_scale": 1.0,
                    "over_deadline": False}

    runs = []
    for monitor in (None, Skips()):
        exp = _exp(KINDS[kind], gate=gate)
        if monitor is not None:
            exp.monitor = monitor
        state, hist = exp.fit()
        runs.append((_final(exp, state), hist))
    (p0, o0, g0, c0, s0), h0 = runs[0]
    (p1, o1, g1, c1, s1), h1 = runs[1]
    assert [h["attempts"] for h in h1] == [1, 2, 3, 1]
    assert [h["loss"] for h in h0] == [h["loss"] for h in h1]
    for k in ("tau", "is_active"):
        assert [h[k] for h in h0] == [h[k] for h in h1]
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
    for name in o0:
        assert torch.equal(o0[name], o1[name]), name
    assert torch.equal(g0, g1) and s0 == s1 == 4
    for a, b in zip(c0, c1):
        assert torch.equal(a, b)
    if gate == "always":
        assert all(h["is_active"] for h in h1)


def test_no_copy_where_the_real_monitor_never_arms():
    """``prod``'s ``StragglerHook`` with the real monitor: a healthy run
    never reaches the skip rung, so no attempt is armed."""
    rec = _events(Hook)
    _, hist = _exp(steps=6).fit(steps=6, hooks=[rec])
    assert rec.loop.snapshot.taken == 0 and rec.loop.snapshot.where is None
    assert all(h["attempts"] == 1 for h in hist)
    assert isinstance(rec.loop.exp.monitor, StragglerMonitor)
    assert rec.loop.exp.monitor.state.count == 6     # past its warm-up


SLOW = "slow@5:0:30;slow@6:0:30;slow@7:0:30"


def test_slow_schedule_arms_the_real_monitor():
    """``slow@5..7``: two over-deadline steps floor the shrink, the third
    skips, and the real monitor's retry is armed only there (two copies:
    step 7's two attempts) and restored once — the run ends bitwise where
    the same run without the schedule ends."""
    kind = KINDS["presample"]
    faulted = dict(kind, **{"runtime.faults.enabled": True,
                            "runtime.faults.spec": SLOW})
    runs = []
    for extra in (kind, faulted):
        rec = _events(Hook)
        exp = _exp(extra, steps=9)
        state, hist = exp.fit(steps=9, hooks=[rec])
        runs.append((rec, hist, _final(exp, state)))
    (_, h0, f0), (rec, h1, f1) = runs
    assert [h["attempts"] for h in h1] == [1] * 7 + [2, 1]
    assert rec.retries == [(7, 0)]
    assert rec.loop.snapshot.taken == 2 and rec.loop.snapshot.restored == 1
    assert [h["loss"] for h in h0] == [h["loss"] for h in h1]
    assert h1[7]["dt_total"] > 30.0 > h1[7]["dt"]
    for name in f0[0]:
        assert torch.equal(f0[0][name], f1[0][name]), name


def test_escalation_leaves_fit_with_the_plane_stopped():
    """The monitor's escalation raises ``MembershipChange`` out of
    ``fit``: the port has no elastic runtime to resync onto, and every
    worker of the data plane is joined on the way out."""
    class Escalate:
        def observe(self, dt):
            return {"skip": False, "b_scale": 1 / 3, "over_deadline": True,
                    "escalate": True}

    exp = _exp()
    exp.monitor = Escalate()
    rec = _events(Hook)
    with pytest.raises(MembershipChange, match="straggler") as ei:
        exp.fit(hooks=[rec])
    assert ei.value.event.kind == "straggler"
    assert ei.value.event.step == 0 and ei.value.event.members == (0,)
    assert rec.loop.plane._threads == []
    assert rec.loop.plane._stop.is_set()
