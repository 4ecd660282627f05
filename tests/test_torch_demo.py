"""The ``demo`` preset on the CPU: the checkpointed training demo that
``repro_torch.train("lm-tiny", preset="demo", device="cpu")`` runs (300
steps, a save every 50, the last 3 kept), then resumed at its last step
and past it. The port alone: no JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.checkpoint.ckpt import Checkpointer  # noqa: E402


def test_demo_preset_trains_checkpoints_and_resumes(tmp_path):
    """``repro_torch.train("lm-tiny", preset="demo", device="cpu")``: the
    checkpointed CPU demo (300 steps, a save every 50, the last 3 kept),
    then resumed at its last step (nothing to train) and to 310."""
    ov = {"ckpt_dir": str(tmp_path / "ckpt")}
    state, hist = repro_torch.train("lm-tiny", preset="demo", device="cpu",
                                    overrides=ov)
    assert len(hist) == 300 and hist[-1]["loss"] < hist[0]["loss"]
    ck = Checkpointer(tmp_path / "ckpt")
    assert ck.steps() == [200, 250, 300]
    assert ck.meta()["pipeline"]["cursor"] > 0
    _, again = repro_torch.train("lm-tiny", preset="demo", device="cpu",
                                 overrides=ov)
    assert again == []
    _, more = repro_torch.train("lm-tiny", preset="demo", device="cpu",
                                overrides=dict(ov, steps=310))
    assert [m["step"] for m in more] == list(range(300, 310))
    assert all(np.isfinite(m["loss"]) for m in more)
    assert ck.steps() == [250, 300, 310]
    assert repro_torch.api.from_dict(ck.meta()["run_config"]).steps == 310
