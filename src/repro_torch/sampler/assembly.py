"""Plan → data: assemble a ``BatchPlan`` (``repro.sampler.assembly`` at
one host).

Two materialisation paths, picked per plan:

* **index gather** (default) — the sources are globally index-addressable
  (synthetic PRNG streams), so the host ``source.gather``\\ s the plan's
  ids;
* **parent reuse** — plans whose rows were selected OUT OF a parent plan
  (``plan.src_rows``, the presample schemes' b-of-B pick) copy the
  already-materialised candidate rows instead of re-gathering.

The multi-host row slicing, row all-gather and partitioned exchange wait
for the distributed slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.plan import BatchPlan


class Assembler:
    """Maps ``BatchPlan``s to gather calls on one host."""

    def __init__(self, source):
        self.source = source

    def assemble(self, plan: BatchPlan, parent=None) -> dict:
        """Materialise ``plan``'s rows as a dict of numpy arrays (+
        ``weights`` when the plan carries them). ``parent`` is an optional
        ``(parent_plan, parent_batch)`` pair for plans carrying
        ``src_rows``."""
        if plan.src_rows is not None and parent is not None:
            _, parent_batch = parent
            batch = {k: np.asarray(v)[plan.src_rows]
                     for k, v in parent_batch.items() if k != "weights"}
        else:
            batch = dict(self.source.gather(plan.gids, epoch=plan.epoch))
        if plan.weights is not None:
            batch["weights"] = np.asarray(plan.weights, np.float32)
        return batch
