"""The slice end to end: the JAX ``Experiment`` and the port's
``Experiment`` train lm-tiny for 3 steps under the ``prod`` preset's fused,
survival-pruned presample path from the same initial params, and must
agree — plan gids exactly, HT weights to float32 rounding, losses to 1e-4
at every step. (The two frameworks' score bytes differ in the last ulps —
direct vs online logsumexp, other summation orders — and the weights are
float functions of them; the selected rows, which a near-tie could flip,
must not differ.) Plus
the port's import boundary (no jax, nothing of ``repro``) and its device
default (the GPU, or an error)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro_torch  # noqa: E402
from repro.api import Experiment as JaxExperiment  # noqa: E402
from repro.api import Hook as JaxHook  # noqa: E402
from repro.api import build_run as jax_build_run  # noqa: E402
from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch.api import Experiment, Hook, build_run  # noqa: E402
from repro_torch.checkpoint import interop  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-4
WEIGHT_RTOL = 1e-6     # a few float32 ulps

OVERRIDES = {"shape.seq_len": 32, "shape.global_batch": 4, "steps": 3,
             "obs.enabled": False, "imp.score_dtype": "float32"}


def _recorder(base):
    class Plans(base):
        def __init__(self):
            self.plans = []

        def on_step_start(self, loop, step, batch, meta):
            self.plans.append((np.array(meta.gids), None if meta.weights is None
                               else np.array(meta.weights),
                               float(meta.is_flag)))
    return Plans()


@pytest.mark.parametrize("extra", [{}, {"imp.tau_th": 1.01}],
                         ids=["prod", "is-active"])
def test_slice_matches_reference_experiment(extra):
    """``prod``'s fused + conservative path at lm-tiny: the default gate
    (τ_th from eq. 26, IS stays off in 3 steps) and a low gate that turns
    importance sampling on from the first plan."""
    overrides = dict(OVERRIDES, **extra)
    jrun = jax_build_run("lm-tiny", preset="prod", overrides=overrides)
    prun = build_run("lm-tiny", preset="prod", overrides=overrides)
    assert (jrun.imp.presample_impl, jrun.imp.score_prune) == \
        ("fused", "conservative")

    jrec = _recorder(JaxHook)
    jexp = JaxExperiment(jrun)
    _, jhist = jexp.fit(hooks=[jrec])

    params = JaxLM(jrun.model).init(jax.random.PRNGKey(jrun.seed))
    flat, _ = _flatten(params)
    prec = _recorder(Hook)
    exp = Experiment(prun, device="cpu")
    interop.load_params(exp.lm, {k: np.asarray(v) for k, v in flat.items()})
    _, hist = exp.fit(hooks=[prec])

    assert len(hist) == len(jhist) == 3
    for step, ((g, w, f), (jg, jw, jf)) in enumerate(zip(prec.plans,
                                                         jrec.plans)):
        np.testing.assert_array_equal(g, jg, err_msg=f"gids, step {step}")
        np.testing.assert_allclose(w, jw, rtol=WEIGHT_RTOL, atol=0,
                                   err_msg=f"weights, step {step}")
        assert f == pytest.approx(jf, rel=1e-6)
    for m, jm in zip(hist, jhist):
        np.testing.assert_allclose(m["loss"], jm["loss"], atol=LOSS_TOL,
                                   rtol=0)
        for key in ("presample_tau", "sampler_active", "is_active"):
            np.testing.assert_allclose(m[key], jm[key], atol=LOSS_TOL)
    if extra:
        assert any(f > 0 for _, _, f in prec.plans), "IS never engaged"
    # the score memory saw the same winners with the same scores
    np.testing.assert_array_equal(exp.sampler.store.seen,
                                  jexp.sampler.store.seen)
    np.testing.assert_allclose(exp.sampler.store.scores,
                               jexp.sampler.store.scores, rtol=1e-5)


def test_import_boundary():
    """``repro_torch`` and every submodule, and ``chip_smoke.py``, import
    neither jax nor anything of ``repro``."""
    code = (
        "import importlib, importlib.util, json, pkgutil, sys\n"
        "sys.path.insert(0, 'src')\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke',"
        " 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for mod in ("repro_torch.kernels.ce_score.ops",
                "repro_torch.kernels.ce_score.ce_score",
                "repro_torch.kernels.flash_attn.ops",
                "repro_torch.kernels.flash_attn.flash_attn",
                "repro_torch.api.serving",
                "repro_torch.launch.serve",
                "repro_torch.kernels.topk_keys.ops",
                "repro_torch.kernels.topk_keys.topk_keys",
                "repro_torch.distributed.collectives",
                "repro_torch.sampler.store",
                "repro_torch.kernels.fused_presample.ops",
                "repro_torch.kernels.fused_presample.ref",
                "repro_torch.kernels.fused_presample.fused_presample",
                "repro_torch.core.is_train",
                "repro_torch.core.importance",
                "repro_torch.optim.api",
                "repro_torch.api.hooks"):
        assert mod in out["modules"], mod
    assert len(out["modules"]) >= 40
    # and statically, so a lazy import inside a function is caught too
    for path in [ROOT / "chip_smoke.py",
                 *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]:
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path}: imports {m}"


def test_entry_points_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.train("lm-tiny", preset="prod", overrides=OVERRIDES)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.train("lm-tiny", preset="smoke")
    from repro_torch.launch import train as launcher
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--arch", "lm-tiny", "--preset", "prod",
                       "--steps=1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.serve("lm-tiny", smoke=True, gen=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.score("lm-tiny", preset="smoke")
    from repro_torch.launch import serve as serve_launcher
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launcher.main(["--arch", "lm-tiny", "--smoke", "--gen", "2"])


def test_launcher_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import train as launcher
    launcher.main(["--arch", "lm-tiny", "--preset", "prod", "--device",
                   "cpu", "--shape.seq_len=16", "--shape.global_batch=2",
                   "--steps=2", "--obs.enabled=false"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 2
    assert all(np.isfinite(float(ln.split()[3])) for ln in lines)


def test_unported_paths_raise():
    """Every scheme route is ported (``imp.presample_impl="step"`` builds
    the in-step ``presample`` kind); checkpoints and sharded scoring are
    the routes still to be ported, and they raise."""
    run = build_run("lm-tiny", preset="prod",
                    overrides=dict(OVERRIDES, **{"imp.presample_impl": "step"}))
    exp = Experiment(run, device="cpu")
    assert exp.step_is_flagged is False
    with pytest.raises(ValueError, match="not ported"):
        Experiment(build_run("lm-tiny", preset="smoke",
                             overrides={"ckpt_dir": "ckpt"}), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        repro_torch.score("lm-tiny", preset="smoke", mesh="pod",
                          device="cpu")
