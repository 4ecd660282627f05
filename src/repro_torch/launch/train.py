"""Training launcher — a thin shell over ``repro_torch.api``.

    python -m repro_torch.launch.train --arch llama3.2-3b --preset prod \
        --shape.global_batch=4 --shape.seq_len=1024 --steps=3 \
        --obs.enabled=false
    python -m repro_torch.launch.train --arch lm-tiny --preset prod \
        --sampler.scheme=history --imp.selection_impl=sharded --steps=8

Flags: reserved ``--arch/--preset/--smoke/--source/--device`` plus dotted
``RunConfig`` overrides; unknown keys are hard errors. Runs on the GPU
unless ``--device cpu`` is given.
"""
from __future__ import annotations


def main(argv=None):
    from repro_torch.api import Experiment, LoggingHook
    exp = Experiment.from_flags(argv)
    exp.fit(hooks=[LoggingHook(every=1)])


if __name__ == "__main__":
    main()
