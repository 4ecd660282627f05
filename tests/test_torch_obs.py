"""Telemetry in the port, against the reference.

* ``ess``, ``variance_gain`` and ``speedup_estimate`` equal to
  ``repro.obs.health``'s on seeded inputs.
* ``VarianceGainHook``'s injected metrics (``variance_gain``,
  ``speedup_est``, ``ess``) over a lm-tiny ``prod`` run with IS on, to
  ``TOL`` of the same run in JAX from the same params.
* ``to_dict(run)`` equal across the packages for every preset, and a
  ``from_json(to_json(run))`` round trip.
* The JSONL, TensorBoard and console sinks: the same bytes (lines) as the
  reference's for the same records, the wall clock fixed.
* ``obs.snapshot()`` of both packages over the same lm-tiny ``smoke``
  runs (the fused presample with conservative pruning, and
  ``selective``): the store's counters and ``store.staleness``
  histogram, the collectives' counters (none for a one-host gather) and
  ``engine.h2d_bytes`` (the winners' indices as int32) are equal.
* A torch leg of ``tests/obs_schema_check.py``: every metric name the
  port's JSONL records carry is in ``repro/obs/schema.py``, with the kind
  the schema declares, and each layer's instruments are live.
"""
import glob
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jax_obs  # noqa: E402
from repro.api import Experiment as JaxExperiment  # noqa: E402
from repro.api import build_run as jax_build_run  # noqa: E402
from repro.api import config as jax_config  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.obs import health as jax_health  # noqa: E402
from repro.obs import schema  # noqa: E402
from repro.obs import sinks as jax_sinks  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.api import Experiment, build_run  # noqa: E402
from repro_torch.api import config  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.obs import health, sinks  # noqa: E402

TOL = 1e-4
HIST_KEYS = {"count", "sum", "min", "max", "avg", "buckets"}


@pytest.fixture(autouse=True)
def _registries_off():
    """Leave both packages' process-wide registries as the tests found
    them (a ``TelemetryHook`` enables its registry)."""
    yield
    for reg in (obs, jax_obs):
        reg.enable(False)
        reg.reset()


def test_health_functions_match_reference():
    rng = np.random.default_rng(0)
    weight_sets = [rng.lognormal(0.0, s, n) for s in (0.1, 1.0, 3.0)
                   for n in (1, 4, 257)]
    weight_sets += [np.ones(8), np.zeros(3), np.array([]),
                    rng.uniform(0, 1, (4, 2)).astype(np.float32)]
    for w in weight_sets:
        assert health.ess(w) == jax_health.ess(w)
        assert health.ess(torch.as_tensor(w)) == jax_health.ess(w)
    taus = [0.0, 0.5, 1.0, 1.0 + 1e-9, 1.2, 3.0, 1e6,
            *rng.uniform(0.5, 4.0, 16)]
    for tau in taus:
        assert health.variance_gain(tau) == jax_health.variance_gain(tau)
        for B, b in ((0, 4), (12, 4), (768, 256), (48, 16)):
            assert health.speedup_estimate(tau, B, b) == \
                jax_health.speedup_estimate(tau, B, b)


def test_variance_gain_hook_matches_reference(tmp_path):
    """``prod``'s fused path at lm-tiny with IS on from the first plan,
    both packages from the same params: the hook's injected metrics agree
    to ``TOL`` at every step, and the port's ``health.*`` gauges hold the
    last step's values."""
    ov = {"shape.seq_len": 16, "shape.global_batch": 4, "steps": 3,
          "imp.score_dtype": "float32", "imp.tau_th": 1.01,
          "obs.enabled": True, "obs.sink": "none"}
    jrun = jax_build_run("lm-tiny", preset="prod", overrides=ov)
    _, jhist = JaxExperiment(jrun).fit()
    params = JaxLM(jrun.model).init(jax.random.PRNGKey(jrun.seed))
    flat, _ = _flatten(params)
    exp = Experiment(build_run("lm-tiny", preset="prod", overrides=ov),
                     device="cpu")
    interop.load_params(exp.lm, {k: np.asarray(v) for k, v in flat.items()})
    _, hist = exp.fit()
    assert len(hist) == len(jhist) == 3
    for m, jm in zip(hist, jhist):
        assert m["sampler_active"] == jm["sampler_active"] == 1.0
        for key in ("variance_gain", "speedup_est", "ess"):
            np.testing.assert_allclose(m[key], jm[key], atol=TOL, rtol=0,
                                       err_msg=key)
    snap = obs.snapshot()
    last = hist[-1]
    assert snap["health.variance_gain"] == last["variance_gain"]
    assert snap["health.speedup_est"] == last["speedup_est"]
    assert snap["health.ess"] == last["ess"]
    assert snap["health.is_active"] == 1.0
    assert snap["health.ess_frac"] == pytest.approx(last["ess"] / 4)


SNAP_LEGS = {
    "fused": {"sampler.scheme": "presample", "imp.presample_impl": "fused",
              "imp.score_prune": "conservative"},
    "selective": {"sampler.scheme": "selective"},
}


@pytest.mark.parametrize("leg", sorted(SNAP_LEGS))
def test_snapshot_matches_reference(leg):
    """Six steps of lm-tiny at ``smoke`` (seq 16, batch 8), telemetry on
    with no sink, in both packages from the same params: the registries
    agree on every ``store.*`` and ``collectives.*`` instrument and on the
    engine's host-to-device bytes and row gathers."""
    ov = {"obs.enabled": True, "obs.sink": "none", "shape.seq_len": 16,
          "shape.global_batch": 8, "steps": 6, **SNAP_LEGS[leg]}
    jrun = jax_build_run("lm-tiny", preset="smoke", overrides=ov)
    jax_obs.reset()
    JaxExperiment(jrun).fit()
    want = jax_obs.snapshot()
    params = JaxLM(jrun.model).init(jax.random.PRNGKey(jrun.seed))
    flat, _ = _flatten(params)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        obs.reset()
        exp = Experiment(build_run("lm-tiny", preset="smoke", overrides=ov),
                         device="cpu")
        interop.load_params(exp.lm,
                            {k: np.asarray(v) for k, v in flat.items()})
        exp.fit()
    finally:
        torch.set_num_threads(n)
    got = obs.snapshot()

    def picked(snap):
        """The instruments of interest that recorded something (a
        registry keeps, zeroed, those that earlier tests in the process
        created)."""
        return {k: v for k, v in snap.items()
                if (k.startswith(("store.", "collectives."))
                    or k in ("engine.h2d_bytes", "engine.row_gathers"))
                and (v["count"] if isinstance(v, dict) else v)}

    assert picked(got) == picked(want)
    assert not any(k.startswith("collectives.gather_host_scores")
                   for k in picked(got))
    if leg == "fused":
        assert got["store.staleness"]["count"] > 0
        assert got["engine.row_gathers"] == 6
        assert got["engine.h2d_bytes"] > 0
    else:
        assert got["store.gather_cache.misses"] > 0


@pytest.mark.parametrize("arch", ["lm-tiny", "llama3.2-3b"])
def test_config_dict_equal_across_packages(arch):
    """Every preset of the reference, for each ported arch: the same
    lossless dict in both packages, each decoding the other's, and a json
    round trip."""
    assert set(config.list_presets()) == set(jax_config.list_presets())
    for name in config.list_presets():
        run = build_run(arch, preset=name, overrides={"steps": 7})
        jrun = jax_build_run(arch, preset=name, overrides={"steps": 7})
        d, jd = config.to_dict(run), jax_config.to_dict(jrun)
        assert d == jd, name
        assert config.from_dict(jd) == run
        assert jax_config.from_dict(d) == jrun
        assert config.from_json(config.to_json(run)) == run
        assert config.to_json(run) == jax_config.to_json(jrun)
    with pytest.raises(config.ConfigError, match="unknown RunConfig keys"):
        config.from_dict(dict(config.to_dict(run), bogus=1))


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        recs.append({
            "event": "step", "step": i, "ts": 1700000000.0 + 0.25 * i,
            "proc": 0,
            "metrics": {"loop.steps": i + 1,
                        "health.tau": float(rng.uniform(1, 2)),
                        "health.gate_flips": True,
                        "loop.step_s": {"count": i + 1,
                                        "sum": float(rng.uniform()),
                                        "min": 0.1, "max": 0.9,
                                        "avg": float(rng.uniform()),
                                        "buckets": {"0.5": i + 1}},
                        "loop.dispatch": {"count": 0, "sum": 0.0,
                                          "min": None, "max": None,
                                          "avg": None, "buckets": {}},
                        "step.loss": float(rng.standard_normal())}})
    return recs


def test_sinks_write_the_reference_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000123.5)
    recs = _records(300)
    # JSONL, rotated at the 64 KiB floor into several generations
    files = {}
    for tag, mod in (("p", sinks), ("j", jax_sinks)):
        sink = mod.JsonlSink(tmp_path / tag / "jsonl", rotate_mb=0.0)
        for r in recs:
            sink.write(r)
        sink.close()
        files[tag] = {f.name: f.read_bytes() for f in sorted(
            (tmp_path / tag / "jsonl").iterdir())}
    assert len(files["p"]) >= 2 and files["p"] == files["j"]
    # TensorBoard event files (the hand-rolled CRC-32C and protobuf)
    for tag, mod in (("p", sinks), ("j", jax_sinks)):
        sink = mod.TensorBoardSink(tmp_path / tag / "tb", proc=0, run="r")
        for r in recs[:20]:
            sink.write(r)
        sink.close()
        files[tag + "tb"] = {f.name: f.read_bytes() for f in sorted(
            (tmp_path / tag / "tb").iterdir())}
    assert files["ptb"] == files["jtb"] and len(files["ptb"]) == 1
    assert sinks.masked_crc32c(b"123456789") == \
        jax_sinks.masked_crc32c(b"123456789")
    # the console line
    lines = {"p": [], "j": []}
    for tag, mod in (("p", sinks), ("j", jax_sinks)):
        sink = mod.ConsoleSink(printer=lambda s, flush, t=tag:
                               lines[t].append(s))
        for r in recs[:5]:
            sink.write(r)
    assert lines["p"] == lines["j"] and len(lines["p"]) == 5
    for kind in ("jsonl", "console", "tensorboard", "none"):
        cfg = config.ObsConfig(enabled=True, sink=kind,
                               dir=str(tmp_path / "mk" / kind))
        assert type(sinks.make_sink(cfg)).__name__ == \
            type(jax_sinks.make_sink(cfg)).__name__
    with pytest.raises(ValueError, match="unknown obs sink"):
        sinks.make_sink(config.ObsConfig(sink="carrier-pigeon"))


def _check_record(rec):
    """``tests/obs_schema_check.py``'s record check, on the port."""
    assert set(rec) == {"event", "step", "ts", "proc", "metrics"}
    assert rec["event"] in {"loop_start", "step", "loop_end"}
    assert isinstance(rec["step"], int) and isinstance(rec["ts"], float)
    assert rec["proc"] == 0
    for name, v in rec["metrics"].items():
        entry = schema.match(name)
        assert entry is not None, f"'{name}' is not in repro/obs/schema.py"
        kind = entry[1]
        if isinstance(v, dict):
            assert kind in ("histogram", "span", "record"), (name, kind)
            assert set(v) == HIST_KEYS, (name, sorted(v))
            assert isinstance(v["count"], int)
        else:
            assert kind in ("counter", "gauge", "record"), (name, kind)
            assert isinstance(v, (int, float)), (name, v)


def test_telemetry_records_use_the_schema(tmp_path):
    """Three lm-tiny legs into one JSONL directory, flushed every 2 steps:
    ``prod``'s fused presample with IS on (6 steps), ``history`` with the
    sharded draw on a 64-example source, whose gate opens (the reference
    schema check's leg, 20 steps), and the in-step ``presample`` kind (6
    steps). Every record and name checks against the schema, and the
    loop, plane, engine, store, pruning and IS-health instruments are
    live."""
    common = {"obs.enabled": True, "obs.dir": str(tmp_path),
              "obs.flush_every": 2}
    tiny = {"steps": 6, "shape.seq_len": 16, "shape.global_batch": 4}
    legs = [("prod", dict(tiny, **{"imp.tau_th": 1.0001})),
            ("smoke", {"steps": 20, "sampler.scheme": "history",
                       "imp.selection_impl": "sharded",
                       "sampler.tau_th": 1.001, "sampler.min_coverage": 0.2,
                       "sampler.smoothing": 0.02,
                       "sampler.temperature": 0.3}),
            ("smoke", tiny)]
    hists = []
    for preset, extra in legs:
        run = build_run("lm-tiny", preset=preset,
                        overrides=dict(common, **extra))
        src = (SyntheticLM(run.model.vocab_size, run.shape.seq_len,
                           n_examples=64, seed=0)
               if run.sampler.scheme == "history" else None)
        hists.append(Experiment(run, source=src, device="cpu").fit()[1])
    assert any(h["sampler_active"] for h in hists[1]), "history gate shut"
    recs = [json.loads(line)
            for f in sorted(glob.glob(f"{tmp_path}/obs-p0.*.jsonl"))
            for line in open(f)]
    events = [r["event"] for r in recs]
    assert events.count("loop_start") == events.count("loop_end") == 3
    assert events.count("step") == 3 + 10 + 3
    for rec in recs:
        _check_record(rec)
    last = recs[-1]["metrics"]
    for name in ("loop.dispatch", "loop.drain_feedback", "loop.step_s",
                 "plane.plan", "plane.gather", "engine.dispatch"):
        assert last[name]["count"] > 0, name
        assert np.isfinite(last[name]["sum"]), name
    for name in ("loop.steps", "plane.batches", "engine.row_gathers",
                 "sampler.d2h_bytes", "kernels.prune.tiles_total",
                 "store.invalidations"):
        assert last[name] > 0, name
    assert last["loop.h2d_bytes"] > 0        # the history and step legs
    for name in ("health.tau", "health.tau_margin", "health.is_active",
                 "health.variance_gain", "health.speedup_est"):
        assert np.isfinite(last[name]), name
    stepped = [r["metrics"] for r in recs if r["event"] == "step"]
    for name in ("step.loss", "step.dt", "step.attempts", "step.dt_total",
                 "step.variance_gain", "step.speedup_est", "step.ess"):
        assert any(name in m for m in stepped), name
    assert all(m["step.attempts"] == 1.0 for m in stepped)
