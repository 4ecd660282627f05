"""Checkpoints and resume in the port, against the reference.

* The port's ``Checkpointer`` on the reference's own cases (atomic round
  trip with keep-last-k GC, an uncommitted step ignored, the async save,
  reaping of a dead run's tmp dirs, ``TopologyMismatch``) and a corrupted
  leaf, as one parametrised test, each case also read back by the
  reference.
* A bf16 leaf: the port writes the bytes the reference's ``Checkpointer``
  writes (npy descr ``'<V2'``, manifest dtype ``bfloat16``) and reads them
  back bit for bit, from either package's file.
* The train state and the score memory under the reference's key names
  and dtypes (``fused``, ``history``, the in-step ``presample`` kind, SGD).
* A JAX checkpoint resumed in torch and a torch checkpoint resumed in JAX
  (lm-tiny, ``prod``'s fused presample and ``history``): the next plans
  bitwise the straight run's, losses within ``LOSS_TOL``.
* A port run resumed from its own checkpoint equals its straight run bit
  for bit (plans, losses, parameters), including the ``presample`` kind's
  draws, whose generator state rides the checkpoint.

The ``demo`` preset's run is ``tests/test_torch_demo.py`` (its own file,
so the runner's per-file workers take it beside these).
"""
import json
import shutil
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.api import Experiment as JaxExperiment  # noqa: E402
from repro.api import Hook as JaxHook  # noqa: E402
from repro.api import build_run as jax_build_run  # noqa: E402
from repro.checkpoint.ckpt import Checkpointer as JaxCheckpointer  # noqa: E402
from repro_torch.api import Experiment, Hook, build_run  # noqa: E402
from repro_torch.checkpoint.ckpt import (Checkpointer,  # noqa: E402
                                         TopologyMismatch, flatten)

LOSS_TOL = 1e-4
BASE = {"shape.seq_len": 16, "shape.global_batch": 4, "steps": 4,
        "obs.enabled": False, "imp.score_dtype": "float32",
        "ckpt_every": 2}
WEIGHT_RTOL = 1e-6     # HT weights across the packages: float32 ulps
TAU_RTOL = 1e-5        # τ EMA over a pool scored one update later
SCHEMES = {"fused": {}, "history": {"sampler.scheme": "history"},
           "fused-is-active": {"imp.tau_th": 1.01}}


# ---------------------------------------------------------------------------
# the Checkpointer
# ---------------------------------------------------------------------------
def _state():
    return {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)},
            "step": np.asarray(7, np.int32)}


def _zeros_like(state):
    return {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)},
            "step": np.asarray(0, np.int32)}


def _case_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    state = _state()
    ck.save(10, state, meta={"pipeline": {"epoch": 1, "cursor": 99}})
    ck.save(20, state)
    ck.save(30, state)
    assert ck.steps() == [20, 30]            # keep=2 GC'd step 10
    assert not list(tmp_path.glob("*.tmp-*"))
    tmpl = _zeros_like(state)
    restored, step = ck.restore(tmpl)
    assert step == 30
    assert restored["a"] is tmpl["a"]        # filled in place
    torch.testing.assert_close(restored["a"], state["a"], rtol=0, atol=0)
    torch.testing.assert_close(restored["b"]["c"], state["b"]["c"], rtol=0,
                               atol=0)
    assert int(restored["step"]) == 7
    assert ck.meta(20) == {} and ck.manifest(30)["n_hosts"] == 1
    return 30, {"a": np.arange(6.0, dtype=np.float32).reshape(2, 3)}


def _case_uncommitted(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"a": torch.zeros(2)})
    bad = tmp_path / "step_5"                # a crash before COMMIT
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert ck.latest_step() == 1 and ck.steps() == [1]
    return 1, {"a": np.zeros(2, np.float32)}


def _case_async(tmp_path):
    ck = Checkpointer(tmp_path)
    w = torch.full((8, 8), 3.0)
    ck.save_async(42, {"w": w})
    w.fill_(5.0)                             # the snapshot was taken
    ck.wait()
    restored, step = ck.restore({"w": torch.zeros(8, 8)})
    assert step == 42 and float(restored["w"][0, 0]) == 3.0
    assert set(ck.last_save) >= {"snapshot_s", "write_s", "commit_s",
                                 "bytes"}
    return 42, {"w": np.full((8, 8), 3.0, np.float32)}


def _case_reaping(tmp_path):
    Checkpointer(tmp_path).save(3, {"a": torch.ones(2)})
    dead = tmp_path / "step_9.tmp-deadbeef"  # a writer that died mid-save
    dead.mkdir()
    (dead / "shard_0.npz").write_bytes(b"partial")
    ck = Checkpointer(tmp_path)
    assert not dead.exists() and ck.steps() == [3]
    return 3, {"a": np.ones(2, np.float32)}


def _case_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=1)
    for s in (2, 4, 6):
        ck.save_async(s, {"a": torch.full((3,), float(s))})
    ck.wait()
    assert ck.steps() == [6]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_6"]
    return 6, {"a": np.full(3, 6.0, np.float32)}


def _case_topology(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(3, {"w": torch.arange(4.0)})
    path = tmp_path / "step_3" / "manifest.json"
    man = json.loads(path.read_text())
    man["n_hosts"] = 2
    path.write_text(json.dumps(man))
    with pytest.raises(TopologyMismatch, match="written by 2"):
        ck.restore({"w": torch.zeros(4)})
    state, step = ck.restore({"w": torch.zeros(4)}, check_topology=False)
    assert step == 3 and state["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert ck.manifest(3)["n_hosts"] == 2
    return None, None


def _case_crc(tmp_path):
    """A flipped byte in a committed leaf fails the restore (the member's
    CRC-32, as ``np.load`` checks it for the reference)."""
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.arange(64.0)})
    path = tmp_path / "step_1" / "shard_0.npz"
    with zipfile.ZipFile(path) as z:
        info = z.getinfo("w.npy")
    raw = bytearray(path.read_bytes())
    end = info.header_offset + 30 + len("w.npy") + 20 + info.file_size
    raw[end - 5] ^= 0x40               # inside the last float's bytes
    path.write_bytes(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        ck.restore({"w": torch.zeros(64)})
    return None, None


@pytest.mark.parametrize("case", [_case_roundtrip, _case_uncommitted,
                                  _case_async, _case_reaping, _case_gc,
                                  _case_topology, _case_crc],
                         ids=["roundtrip", "uncommitted", "async", "reaping",
                              "gc", "topology", "crc"])
def test_checkpointer(case, tmp_path):
    """Each of the reference's checkpointer cases on the port's
    ``Checkpointer``; the reference reads what the port wrote."""
    step, want = case(tmp_path)
    if step is None:
        return
    tmpl = {k: jnp.zeros(v.shape, v.dtype) for k, v in want.items()}
    got, jstep = JaxCheckpointer(tmp_path).restore(tmpl)
    assert jstep == step
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)


def test_bf16_leaf_bytes_equal_reference(tmp_path):
    """A bf16 leaf (2-D and 0-d) as the reference writes it: the same npy
    member bytes, the same manifest entry, and read back bit for bit by
    the port from either package's checkpoint."""
    x = np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32)
    w = torch.from_numpy(x).to(torch.bfloat16)
    jw = jnp.asarray(x).astype(jnp.bfloat16)
    bits = w.view(torch.int16).numpy()
    np.testing.assert_array_equal(np.asarray(jw).view(np.int16), bits)
    port = {"w": w, "s": torch.tensor(1.5, dtype=torch.bfloat16)}
    ref = {"w": jw, "s": jnp.asarray(1.5, jnp.bfloat16)}
    Checkpointer(tmp_path / "p").save(1, port)
    JaxCheckpointer(tmp_path / "j").save(1, ref)
    members = {}
    for pkg in ("p", "j"):
        with zipfile.ZipFile(tmp_path / pkg / "step_1" / "shard_0.npz") as z:
            members[pkg] = {n: z.read(n) for n in z.namelist()}
    assert members["p"] == members["j"]
    assert members["p"]["w.npy"].startswith(b"\x93NUMPY\x01\x00")
    assert b"'descr': '<V2'" in members["p"]["w.npy"]
    man = {pkg: json.loads((tmp_path / pkg / "step_1" /
                            "manifest.json").read_text())["keys"]
           for pkg in ("p", "j")}
    assert man["p"] == man["j"] == {
        "s": {"shape": [], "dtype": "bfloat16"},
        "w": {"shape": [5, 7], "dtype": "bfloat16"}}
    for pkg in ("p", "j"):
        tmpl = {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                "s": torch.zeros((), dtype=torch.bfloat16)}
        got, _ = Checkpointer(tmp_path / pkg).restore(tmpl)
        np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                      bits)
        assert float(got["s"]) == 1.5


# ---------------------------------------------------------------------------
# the train state under the reference's keys
# ---------------------------------------------------------------------------
def _keys(ckdir, step):
    return json.loads((ckdir / f"step_{step}" / "manifest.json")
                      .read_text())["keys"]


@pytest.mark.parametrize("preset,extra", [
    ("prod", {}), ("prod", {"sampler.scheme": "history"}),
    ("smoke", {}), ("smoke", {"optim.name": "sgd"})],
    ids=["fused", "history", "presample-step", "sgd"])
def test_checkpoint_keys_match_reference(preset, extra, tmp_path):
    """Every key the reference writes, with its shape and dtype, and one
    port-only key, ``train/torch_rng``; the manifests' meta agree."""
    ov = dict(BASE, steps=2, **extra)
    JaxExperiment(jax_build_run("lm-tiny", preset=preset, overrides=dict(
        ov, ckpt_dir=str(tmp_path / "j")))).fit()
    Experiment(build_run("lm-tiny", preset=preset, overrides=dict(
        ov, ckpt_dir=str(tmp_path / "p"))), device="cpu").fit()
    jkeys, pkeys = _keys(tmp_path / "j", 2), _keys(tmp_path / "p", 2)
    extra_keys = set(pkeys) - set(jkeys)
    assert extra_keys == {"train/torch_rng"}
    assert pkeys["train/torch_rng"]["dtype"] == "uint8"
    assert {k: pkeys[k] for k in jkeys} == jkeys
    jmeta = JaxCheckpointer(tmp_path / "j").meta()
    pmeta = Checkpointer(tmp_path / "p").meta()
    assert set(pmeta) == {"pipeline", "run_config", "source"}
    assert pmeta["run_config"] == dict(jmeta["run_config"],
                                       ckpt_dir=str(tmp_path / "p"))
    assert (pmeta["pipeline"], pmeta["source"]) == \
        (jmeta["pipeline"], jmeta["source"])


# ---------------------------------------------------------------------------
# resume across the packages
# ---------------------------------------------------------------------------
def _recorder(base):
    class Rec(base):
        def __init__(self):
            self.plans, self.losses = [], []

        def on_step_start(self, loop, step, batch, meta):
            self.plans.append((step, np.array(meta.gids),
                               None if meta.weights is None
                               else np.array(meta.weights),
                               float(meta.is_flag)))

        def on_step_end(self, loop, step, metrics):
            self.losses.append((step, metrics["loss"]))
    return Rec()


def _same_plans(got, want, rtol=0.0):
    """Steps and gids bitwise; weights and the τ flag bitwise, or to
    ``rtol`` across the packages."""
    assert [p[0] for p in got] == [p[0] for p in want]
    for (step, g, w, f), (_, jg, jw, jf) in zip(got, want):
        np.testing.assert_array_equal(g, jg, err_msg=f"gids, step {step}")
        if jw is None:
            assert w is None
        else:
            np.testing.assert_allclose(w, jw, rtol=rtol, atol=0,
                                       err_msg=f"weights, step {step}")
        assert f == pytest.approx(jf, rel=rtol, abs=0)


def _close_losses(got, want):
    want = dict(want)
    for step, loss in got:
        np.testing.assert_allclose(loss, want[step], atol=LOSS_TOL, rtol=0)


def _copy_step(src, step, dst):
    shutil.copytree(src / f"step_{step}", dst / f"step_{step}")
    return dst


def _jax_run(ov, ckdir, steps=None):
    run = jax_build_run("lm-tiny", preset="prod",
                        overrides=dict(ov, ckpt_dir=str(ckdir)))
    rec = _recorder(JaxHook)
    JaxExperiment(run).fit(steps=steps, hooks=[rec])
    return rec


def _port_run(ov, ckdir, steps=None):
    run = build_run("lm-tiny", preset="prod",
                    overrides=dict(ov, ckpt_dir=str(ckdir)))
    rec = _recorder(Hook)
    Experiment(run, device="cpu").fit(steps=steps, hooks=[rec])
    return rec


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_jax_checkpoint_resumes_in_torch(scheme, tmp_path):
    """JAX trains 4 steps, saving at 2 and 4; the port resumes JAX's step 2
    (``from_checkpoint``, the run rebuilt from the manifest) and plans
    steps 2 and 3 as JAX's own resume from that checkpoint does (gids
    bitwise, weights to float32 ulps), losses to ``LOSS_TOL``. With the
    gate closed (``fused``, ``history``) that is also the straight run's
    plans, bit for bit, and its losses. With IS on from the first plan
    (``fused-is-active``) the gids still equal the straight run's, but in
    both packages the resumed run scores its first pool against the
    checkpoint's params, where the straight run scored it against the
    params one update earlier, so its weights and losses differ from the
    straight run's (by 2.5e-4 in the loss of step 2, JAX's own resume
    included)."""
    ov = dict(BASE, **SCHEMES[scheme])
    straight = _jax_run(ov, tmp_path / "j")
    jres = _recorder(JaxHook)
    JaxExperiment.from_checkpoint(
        _copy_step(tmp_path / "j", 2, tmp_path / "jr")).fit(
            steps=4, hooks=[jres])
    exp = Experiment.from_checkpoint(
        _copy_step(tmp_path / "j", 2, tmp_path / "pr"), device="cpu")
    assert exp.run.sampler.scheme == ("history" if scheme == "history"
                                      else "presample")
    pres = _recorder(Hook)
    exp.fit(steps=4, hooks=[pres])
    assert [s for s, _ in pres.losses] == [2, 3]
    _same_plans(pres.plans, jres.plans, rtol=WEIGHT_RTOL)
    _close_losses(pres.losses, jres.losses)
    for (_, g, _, _), (_, jg, _, _) in zip(pres.plans, straight.plans[2:]):
        np.testing.assert_array_equal(g, jg)
    if scheme == "fused-is-active":
        assert all(f > 0 for *_, f in pres.plans), "IS never engaged"
    else:
        _same_plans(pres.plans, straight.plans[2:])
        _close_losses(pres.losses, straight.losses)
    # the resumed port run wrote its own step 4
    assert Checkpointer(tmp_path / "pr").steps() == [2, 4]


@pytest.mark.parametrize("scheme", ["fused", "history"])
def test_torch_checkpoint_resumes_in_jax(scheme, tmp_path):
    """The port trains 4 steps, saving at 2 and 4; JAX resumes the port's
    step 2 and plans steps 2 and 3 as the port run did, bit for bit;
    losses to ``LOSS_TOL``."""
    ov = dict(BASE, **SCHEMES[scheme])
    straight = _port_run(ov, tmp_path / "p")
    jres = _recorder(JaxHook)
    JaxExperiment.from_checkpoint(
        _copy_step(tmp_path / "p", 2, tmp_path / "jr")).fit(
            steps=4, hooks=[jres])
    assert [s for s, _ in jres.losses] == [2, 3]
    _same_plans(jres.plans, straight.plans[2:])
    _close_losses(jres.losses, straight.losses)


@pytest.mark.parametrize("preset,extra,gate", [
    ("prod", {}, None),
    ("prod", {"sampler.scheme": "history"}, None),
    ("smoke", {}, "always")],
    ids=["fused", "history", "presample-step"])
def test_port_resume_is_bitwise(preset, extra, gate, tmp_path):
    """A run stopped at step 2 and resumed from its checkpoint equals the
    straight run bit for bit: plans, losses, final parameters and score
    memory. The
    ``presample`` kind under ``gate="always"`` draws with the train
    state's generator every step, so this holds only because its state
    rides the checkpoint."""
    ov = dict(BASE, **extra)

    def run(ckdir, steps, from_ckpt=False):
        rec = _recorder(Hook)
        exp = (Experiment.from_checkpoint(ckdir, device="cpu", gate=gate)
               if from_ckpt else Experiment(build_run(
                   "lm-tiny", preset=preset,
                   overrides=dict(ov, ckpt_dir=str(ckdir))),
                   device="cpu", gate=gate))
        state, _ = exp.fit(steps=steps, hooks=[rec])
        return rec, {k: v.detach().clone()
                     for k, v in state["params"].items()}, \
            flatten(exp.sampler.state_dict())

    straight, p_straight, s_straight = run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    resumed, p_resumed, s_resumed = run(tmp_path / "b", 4, from_ckpt=True)
    _same_plans(resumed.plans, straight.plans[2:])
    assert resumed.losses == straight.losses[2:]
    for name, v in p_straight.items():
        torch.testing.assert_close(p_resumed[name], v, rtol=0, atol=0,
                                   msg=name)
    # the score memory too: the save drained the step's pending feedback.
    # The fused pool at the resume was rescored against the checkpoint's
    # params (see the JAX test above), so only the stored scores of that
    # pool's race winners and the τ EMA it fed may differ, by one update
    assert s_resumed.keys() == s_straight.keys()
    rescored = preset == "prod" and not extra
    cursor = Checkpointer(tmp_path / "b").meta(2)["pipeline"]["cursor"]
    pool = set(range(cursor, cursor + 3 * BASE["shape.global_batch"]))
    for key, v in s_straight.items():
        if rescored and key == "store/scores":
            moved = np.flatnonzero(s_resumed[key] != v)
            assert set(moved.tolist()) <= pool, moved
        elif rescored and key == "tau_ema":
            np.testing.assert_allclose(s_resumed[key], v, rtol=TAU_RTOL)
        else:
            np.testing.assert_array_equal(s_resumed[key], v, err_msg=key)
    # resumed at the final step: nothing trained, nothing rewritten
    step4 = tmp_path / "b" / "step_4" / "shard_0.npz"
    before = (step4.stat().st_mtime_ns, step4.read_bytes())
    again, _, _ = run(tmp_path / "b", 4, from_ckpt=True)
    assert again.losses == []
    assert (step4.stat().st_mtime_ns, step4.read_bytes()) == before
