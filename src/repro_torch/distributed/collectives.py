"""The selection plane's collectives at one host
(``repro.distributed.collectives``, the calls the sampler and the
loop's retry vote make).

Each collective counts its call and this host's payload bytes at entry
(``collectives.<name>.calls`` / ``.bytes``, inert unless telemetry is
on), so a one-process run keeps the traffic shape of a many-host one.
At ``n_hosts == 1`` each is the identity. Many hosts need the
distributed slice (``torch.distributed`` collectives with the
reference's deadline envelope); until it lands they raise.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs


def _note_collective(name: str, payload) -> None:
    if not obs.enabled():
        return
    obs.counter(f"collectives.{name}.calls").inc()
    tree = payload if isinstance(payload, dict) else {"x": payload}
    obs.counter(f"collectives.{name}.bytes").inc(
        int(sum(np.asarray(v).nbytes for v in tree.values())))


def _single_host(name: str, n_hosts) -> None:
    if int(n_hosts) != 1:
        raise NotImplementedError(
            f"{name} over {n_hosts} hosts is not ported yet: many-host "
            f"collectives come with the port's distributed slice")


def strided_shard_size(n_global: int, host_id: int, n_hosts: int) -> int:
    """Slots host ``host_id`` owns under strided ownership
    ``{i : i % H == h}`` — ``ceil((n - h) / H)``, for any ``n % H``."""
    return (int(n_global) - int(host_id) + int(n_hosts) - 1) // int(n_hosts)


def gather_host_scores(local_scores, *, host_id=0, n_hosts=1,
                       n_global=None):
    """Host-local strided score shard -> the GLOBAL score vector."""
    local = np.asarray(local_scores, np.float32).reshape(-1)
    _note_collective("gather_host_scores", local)
    _single_host("gather_host_scores", n_hosts)
    return local if n_global is None else local[:n_global]


def allgather_rows(local_rows, *, n_rows: int, n_hosts=1):
    """Per-host contiguous row blocks -> all ``n_rows`` rows (an array or
    a dict of arrays sharing the row axis)."""
    single = not isinstance(local_rows, dict)
    tree = {"x": local_rows} if single else local_rows
    _note_collective("allgather_rows", tree)
    _single_host("allgather_rows", n_hosts)
    out = {k: np.asarray(v)[:n_rows] for k, v in tree.items()}
    return out["x"] if single else out


def allreduce_stats(local_stats, *, n_hosts=1):
    """Sum of the per-shard sufficient-stat vectors across hosts."""
    local = np.asarray(local_stats, np.float64)
    _note_collective("allreduce_stats", local)
    _single_host("allreduce_stats", n_hosts)
    return local.copy()


def exchange_topk(candidates, *, k_each: int, n_hosts=1):
    """Every host's fixed-size candidate block, concatenated host-major
    (``(k_each·H, ...)`` per key)."""
    _note_collective("exchange_topk", candidates)
    if obs.enabled():
        obs.histogram("collectives.exchange_topk.k_each").observe(int(k_each))
    for k, v in candidates.items():
        if np.asarray(v).shape[0] != int(k_each):
            raise ValueError(f"candidate block {k!r} has "
                             f"{np.asarray(v).shape[0]} rows != k_each "
                             f"{k_each} (blocks must be padded)")
    return allgather_rows(candidates, n_rows=int(k_each) * int(n_hosts),
                          n_hosts=n_hosts)


def allreduce_any(flag, *, n_hosts=1) -> bool:
    """Global OR of one per-host boolean — the lockstep vote primitive.
    A host-local decision that re-dispatches device work (the straggler
    retry vote, derived from this host's wall clock) must take the same
    branch on every host, or a host re-enters the step's collectives
    alone. One bool per step; the identity at one host."""
    local = np.asarray([bool(flag)])
    _note_collective("allreduce_any", local)
    _single_host("allreduce_any", n_hosts)
    return bool(flag)
