"""Training launcher — a thin shell over ``repro_torch.api``.

    python -m repro_torch.launch.train --arch llama3.2-3b --preset prod \
        --shape.global_batch=4 --shape.seq_len=1024 --steps=3 \
        --obs.dir=runs/obs --ckpt_dir=runs/ckpt
    python -m repro_torch.launch.train --arch lm-tiny --preset prod \
        --sampler.scheme=history --imp.selection_impl=sharded --steps=8
    python -m repro_torch.launch.train --arch lm-tiny --preset prod \
        --data.prefetch_depth=3 --data.device_put=true --steps=8

Flags: reserved ``--arch/--preset/--smoke/--source/--device`` plus dotted
``RunConfig`` overrides; unknown keys are hard errors. Runs on the GPU
unless ``--device cpu`` is given.

Data: the depth-N data plane (``--data.prefetch_depth=N``, default 2)
pipelines plan → gather → host-to-card copy behind the update step for
the pure-plan schemes (``uniform``, ``presample``); ``--data.device_put=
false`` leaves the copy to the step. Faults: ``--runtime.faults.enabled=
true --runtime.faults.spec='gather@4;slow@5:0:0.4'`` injects a gather
error and a straggler (the loop retries the step).

Resume: with ``--ckpt_dir`` the run starts from the newest committed
checkpoint in that directory (the train state, the score memory and the
plan cursor) and saves every ``--ckpt_every`` steps and at the end, so
rerunning the same command with a higher ``--steps`` continues it, and
rerunning it at the same ``--steps`` trains and writes nothing. The
directory may hold a checkpoint of the JAX package's launcher: both write
one format. ``prod`` turns telemetry on: JSONL records under
``--obs.dir`` (``--obs.sink=console|tensorboard|none`` to change).
"""
from __future__ import annotations


def main(argv=None):
    from repro_torch.api import Experiment, LoggingHook
    exp = Experiment.from_flags(argv)
    exp.fit(hooks=[LoggingHook(every=1)])


if __name__ == "__main__":
    main()
