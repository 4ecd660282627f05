"""Training launcher — a thin shell over ``repro_torch.api``.

    python -m repro_torch.launch.train --arch llama3.2-3b --preset prod \
        --shape.global_batch=4 --shape.seq_len=1024 --steps=3 \
        --obs.dir=runs/obs --ckpt_dir=runs/ckpt
    python -m repro_torch.launch.train --arch lm-tiny --preset prod \
        --sampler.scheme=history --imp.selection_impl=sharded --steps=8

Flags: reserved ``--arch/--preset/--smoke/--source/--device`` plus dotted
``RunConfig`` overrides; unknown keys are hard errors. Runs on the GPU
unless ``--device cpu`` is given.

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
